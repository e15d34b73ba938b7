// Paged packed-KV4 flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/kv_attention.py`
// `kv4_paged_decode_attention` (`_paged_kernel` -> `_flash_step` ->
// `_dequant4_block` + `_flash_core`): one new query token per sequence
// attends over its pages through the block table; K/V pages hold int4
// nibbles packed two per byte along head_dim with one f32 scale per
// (token, kv head). f32 online softmax, scale hd**-0.5, NEG_INF = -2e38,
// causal mask i*ps + off <= pos, drain acc / max(l, 1e-30) in q's dtype.
//
// Bound: bytes. Each (b, kv head) reads its pages once (hd/2 + 4 bytes
// per token for K and again for V); the arithmetic is ~4*G*hd flops per
// token. Design: one block per (b, kv head), so the G query heads of the
// group share every page load; the block reads its own page ids from
// the table (the Pallas scalar prefetch), unpacks and dequantizes each
// page into shared memory, and stops at the page that holds pos (later
// pages get p = exp(-2e38 - m) = 0 exactly in the reference). Inactive
// slots (pos 0, table row of zeros) read the null page 0.
//
// The verify kernel replaces `kv4_paged_verify_attention`
// (`_paged_verify_kernel`): a T-token window per sequence, window token
// t at query position pos + t, grid (KVH, B, T). Its contract is to be
// bit-exact with T calls of the decode kernel at pos, pos+1, ..., so the
// whole per-query body is ONE `__noinline__` device function that both
// `__global__` kernels call: the same compiled instructions, in the same
// order, for every query. Each (b, h, t) block reloads the pages it
// reads (sharing them across t is later work, and must keep this
// per-query order).
//
// The tiered kernel replaces `kv_tiered_paged_decode_attention`
// (`_tiered_paged_kernel`, `_dequant2_block`, `_unpack2`): the decode
// kernel plus a per-page tier table. Page `step` of a sequence comes
// from the KV2 slab (P2, ps, KVH, hd/4) -- four signed 2-bit fields per
// byte, field i of byte j = element 4j+i -- when its tier id is 1, else
// from the KV4 slab; only the slab the tier names is read (the Pallas
// index maps also DMA the other slab's null page, because every grid
// step must name a block). The dequantized page lands in the same
// shared-memory rows as a KV4 page and the rest of the body is the same
// source: the body is a template on TIERED, and the tiered kernel runs
// its TIERED instance, the decode and verify kernels the other. The two
// instances do the same float operations in the same order, so an
// all-tier-0 call is bit-exact with the decode kernel and a demoted
// page gives the bits of its clamped KV4 image (both held on the card).
// One instance with a run-time tier test (null table for decode and
// verify) slowed those two kernels by 8-9% on an H100
// (`tools/ab_kernels.py`): its page loop is latency-bound, and the test
// changed how it compiled. Bound: bytes,
// each page read once at its tier's width ((hd/2 + 4) * 2 bytes per
// token and head for KV4, (hd/4 + 4) * 2 for KV2).
//
// The contiguous kernel replaces `kv4_decode_attention` (`_kernel`): one
// query token per sequence over a (B, S, KVH, HD/2) cache in blocks of
// PS tokens, read as the page pool (B*S/PS, PS, KVH, HD/2) whose page
// b*(S/PS) + i is block i of sequence b. The table is implicit: the
// kernel offsets the cache pointers to sequence b and the body takes
// page = step, in its CONTIGUOUS instance; the float operations are
// those of the decode kernel, so a contiguous call is bit-exact with a
// paged call whose pages of PS tokens tile the same cache (the Pallas
// contract; held on the card). A first version ran the decode
// kernel's instance with a table written into shared memory: it was
// bit-exact by construction, but the decode and verify kernels, which
// share that instance, read 11% and 10% slower on an H100
// (`tools/ab_kernels.py` against the parent), as the shared-memory
// table pointer changed how the body compiled. The caller picks PS (S
// a multiple of it): the body holds a whole block in shared memory as
// f32, (2*HD + 1) * 4 bytes a token, so the Pallas default of 512
// tokens (264 KB of K rows alone at HD = 128) does not fit; the
// wrapper's 16 is the engine's page size. Bound: bytes, (HD/2 + 4) * 2
// per token and head, each block read once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF (-2.0e38f)
#define THREADS 128

// KV2 page `page` dequantized into the shared-memory rows of a KV4 page:
// k_s (PS, HD+1), v_s (PS, HD). A byte holds four signed 2-bit fields,
// field f of byte j being element 4j+f.
__device__ __noinline__ void load_kv2_page(
    const int8_t* __restrict__ k2_pages, const float* __restrict__ k2_scale,
    const int8_t* __restrict__ v2_pages, const float* __restrict__ v2_scale,
    long page, float* k_s, float* v_s, int KVH, int h, int HD, int PS) {
  const int KP = HD + 1, HQ = HD / 4;
  for (int i = threadIdx.x; i < PS * HQ; i += blockDim.x) {
    const int t = i / HQ, j = i % HQ;
    const long tok = (page * PS + t) * KVH + h;
    const uint8_t kb = (uint8_t)k2_pages[tok * HQ + j];
    const uint8_t vb = (uint8_t)v2_pages[tok * HQ + j];
    const float ks = k2_scale[tok], vs = v2_scale[tok];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // field f sign-extended: (int8)(b << (6 - 2f)) >> 6
      k_s[t * KP + 4 * j + f] = (float)((int8_t)(kb << (6 - 2 * f)) >> 6) * ks;
      v_s[t * HD + 4 * j + f] = (float)((int8_t)(vb << (6 - 2 * f)) >> 6) * vs;
    }
  }
}

// One query group (the G heads of KV head h) at absolute position p over
// the pages named by `table` (NS entries); q and out at element offset
// qbase, (G, HD) each. TIERED: `tiers` (NS entries) sends a tier-1 page
// to the KV2 slab k2_pages/k2_scale/v2_* (not read otherwise).
// CONTIGUOUS: page `step` is page `step` of k_pages/v_pages (`table` is
// not read).
template <bool TIERED, bool CONTIGUOUS = false>
__device__ __noinline__ void paged_attention_query(
    const void* __restrict__ q, int q_bf16, long qbase,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale,
    const int8_t* __restrict__ k2_pages, const float* __restrict__ k2_scale,
    const int8_t* __restrict__ v2_pages, const float* __restrict__ v2_scale,
    const int32_t* __restrict__ table, const int32_t* __restrict__ tiers,
    int p, void* __restrict__ out, int KVH, int h, int G, int HD, int PS,
    int NS, float scale) {
  extern __shared__ float smem[];
  const int KP = HD + 1;                      // padded K row: no conflicts
  float* q_s = smem;                          // [G][HD]
  float* k_s = q_s + G * HD;                  // [PS][HD+1]
  float* v_s = k_s + PS * KP;                 // [PS][HD]
  float* s_s = v_s + PS * HD;                 // [G][PS]
  float* acc_s = s_s + G * PS;                // [G][HD]
  float* m_s = acc_s + G * HD;                // [G]
  float* l_s = m_s + G;                       // [G]
  float* c_s = l_s + G;                       // [G]

  const int tid = threadIdx.x;
  const int HP = HD / 2;
  for (int i = tid; i < G * HD; i += blockDim.x) {
    q_s[i] = q_bf16 ? __bfloat162float(
                          reinterpret_cast<const __nv_bfloat16*>(q)[qbase + i])
                    : reinterpret_cast<const float*>(q)[qbase + i];
    acc_s[i] = 0.0f;
  }
  if (tid < G) { m_s[tid] = NEG_INF; l_s[tid] = 0.0f; }
  const int last = min(max(p, 0) / PS, NS - 1);
  __syncthreads();

  for (int step = 0; step <= last; ++step) {
    const long page = CONTIGUOUS ? step : table[step];
    if (TIERED && tiers[step] == 1) {
      load_kv2_page(k2_pages, k2_scale, v2_pages, v2_scale, page, k_s, v_s,
                    KVH, h, HD, PS);
    } else {
      for (int i = tid; i < PS * HP; i += blockDim.x) {
        const int t = i / HP, j = i % HP;
        const long tok = (page * PS + t) * KVH + h;
        const int8_t kb = k_pages[tok * HP + j], vb = v_pages[tok * HP + j];
        const float ks = k_scale[tok], vs = v_scale[tok];
        // two's-complement nibbles: (x << 4) >> 4 and x >> 4 sign-extend
        k_s[t * KP + 2 * j] = (float)((int8_t)((uint8_t)kb << 4) >> 4) * ks;
        k_s[t * KP + 2 * j + 1] = (float)(kb >> 4) * ks;
        v_s[t * HD + 2 * j] = (float)((int8_t)((uint8_t)vb << 4) >> 4) * vs;
        v_s[t * HD + 2 * j + 1] = (float)(vb >> 4) * vs;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * PS; i += blockDim.x) {
      const int g = i / PS, t = i % PS;
      float dot = 0.0f;
      for (int d = 0; d < HD; ++d) dot = fmaf(q_s[g * HD + d], k_s[t * KP + d], dot);
      s_s[i] = (step * PS + t <= p) ? dot * scale : NEG_INF;
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float mx = m_s[g];
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, s_s[g * PS + t]);
      float sum = 0.0f;
      for (int t = 0; t < PS; ++t) {
        const float e = expf(s_s[g * PS + t] - mx);
        s_s[g * PS + t] = e;
        sum += e;
      }
      const float corr = expf(m_s[g] - mx);
      l_s[g] = l_s[g] * corr + sum;
      c_s[g] = corr;
      m_s[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += blockDim.x) {
      const int g = i / HD, d = i % HD;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < PS; ++t) a = fmaf(s_s[g * PS + t], v_s[t * HD + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * HD; i += blockDim.x) {
    const float o = acc_s[i] / fmaxf(l_s[i / HD], 1e-30f);
    if (q_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[qbase + i] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(out)[qbase + i] = o;
  }
}

// Every kernel takes the same arguments: the KV2 slab and the tier table
// are read by the tiered kernel only (null for the others).
#define PAGED_ARGS                                                         \
    const void* __restrict__ q, int q_bf16,                                \
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale, \
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale, \
    const int8_t* __restrict__ k2_pages,                                   \
    const float* __restrict__ k2_scale,                                    \
    const int8_t* __restrict__ v2_pages,                                   \
    const float* __restrict__ v2_scale,                                    \
    const int32_t* __restrict__ tables, const int32_t* __restrict__ tiers, \
    const int32_t* __restrict__ pos, void* __restrict__ out, int KVH,      \
    int G, int HD, int PS, int NS, float scale

// grid (KVH, B): q/out (B, KVH, G, HD), query position pos[b].
__global__ void kv4_paged_decode_kernel(PAGED_ARGS) {
  const int b = blockIdx.y, h = blockIdx.x;
  paged_attention_query<false>(
      q, q_bf16, ((long)b * KVH + h) * G * HD, k_pages, k_scale, v_pages,
      v_scale, nullptr, nullptr, nullptr, nullptr, tables + (long)b * NS,
      nullptr, pos[b], out, KVH, h, G, HD, PS, NS, scale);
}

// grid (KVH, B, T): q/out (B, T, KVH, G, HD), query position pos[b] + t.
__global__ void kv4_paged_verify_kernel(PAGED_ARGS) {
  const int b = blockIdx.y, h = blockIdx.x, t = blockIdx.z, T = gridDim.z;
  paged_attention_query<false>(
      q, q_bf16, (((long)b * T + t) * KVH + h) * G * HD, k_pages, k_scale,
      v_pages, v_scale, nullptr, nullptr, nullptr, nullptr,
      tables + (long)b * NS, nullptr, pos[b] + t, out, KVH, h, G, HD, PS, NS,
      scale);
}

// grid (KVH, B): the decode kernel with tier table tiers (B, NS).
__global__ void kv_tiered_paged_decode_kernel(PAGED_ARGS) {
  const int b = blockIdx.y, h = blockIdx.x;
  paged_attention_query<true>(
      q, q_bf16, ((long)b * KVH + h) * G * HD, k_pages, k_scale, v_pages,
      v_scale, k2_pages, k2_scale, v2_pages, v2_scale, tables + (long)b * NS,
      tiers + (long)b * NS, pos[b], out, KVH, h, G, HD, PS, NS, scale);
}

// grid (KVH, B): the contiguous cache, NS = S / PS blocks a sequence;
// k_pages/v_pages (B, S, KVH, HD/2), k_scale/v_scale (B, S, KVH).
__global__ void kv4_decode_kernel(PAGED_ARGS) {
  const int b = blockIdx.y, h = blockIdx.x;
  const long seq = (long)b * NS * PS * KVH;        // sequence b's tokens
  paged_attention_query<false, true>(
      q, q_bf16, ((long)b * KVH + h) * G * HD, k_pages + seq * (HD / 2),
      k_scale + seq, v_pages + seq * (HD / 2), v_scale + seq, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, pos[b], out, KVH, h, G,
      HD, PS, NS, scale);
}

typedef void (*attention_kernel)(PAGED_ARGS);

static int launch(attention_kernel kernel, dim3 grid, const void* q,
                  int q_bf16, const void* k_pages, const void* k_scale,
                  const void* v_pages, const void* v_scale,
                  const void* k2_pages, const void* k2_scale,
                  const void* v2_pages, const void* v2_scale,
                  const void* tables, const void* tiers, const void* pos,
                  void* out, int KVH, int G, int HD, int PS, int NS,
                  void* stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * HD * 2 + (size_t)PS * (HD + 1) + (size_t)PS * HD +
       (size_t)G * PS + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, q_bf16, (const int8_t*)k_pages, (const float*)k_scale,
      (const int8_t*)v_pages, (const float*)v_scale, (const int8_t*)k2_pages,
      (const float*)k2_scale, (const int8_t*)v2_pages,
      (const float*)v2_scale, (const int32_t*)tables, (const int32_t*)tiers,
      (const int32_t*)pos, out, KVH, G, HD, PS, NS,
      (float)pow((double)HD, -0.5));
  return (int)cudaGetLastError();
}

extern "C" int kv4_paged_decode_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int KVH, int G, int HD, int PS,
    int NS, void* stream) {
  return launch(kv4_paged_decode_kernel, dim3(KVH, B), q, q_bf16, k_pages,
                k_scale, v_pages, v_scale, nullptr, nullptr, nullptr, nullptr,
                tables, nullptr, pos, out, KVH, G, HD, PS, NS, stream);
}

extern "C" int kv4_paged_verify_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int T, int KVH, int G, int HD,
    int PS, int NS, void* stream) {
  return launch(kv4_paged_verify_kernel, dim3(KVH, B, T), q, q_bf16,
                k_pages, k_scale, v_pages, v_scale, nullptr, nullptr,
                nullptr, nullptr, tables, nullptr, pos, out, KVH, G, HD, PS,
                NS, stream);
}

extern "C" int kv_tiered_paged_decode_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* k2_pages,
    const void* k2_scale, const void* v2_pages, const void* v2_scale,
    const void* tables, const void* tiers, const void* pos, void* out,
    int B, int KVH, int G, int HD, int PS, int NS, void* stream) {
  return launch(kv_tiered_paged_decode_kernel, dim3(KVH, B), q, q_bf16,
                k_pages, k_scale, v_pages, v_scale, k2_pages, k2_scale,
                v2_pages, v2_scale, tables, tiers, pos, out, KVH, G, HD, PS,
                NS, stream);
}

// k_q/v_q (B, S, KVH, HD/2), k_s/v_s (B, S, KVH), S = NS * PS.
extern "C" int kv4_decode_launch(
    const void* q, int q_bf16, const void* k_q, const void* k_s,
    const void* v_q, const void* v_s, const void* pos, void* out, int B,
    int KVH, int G, int HD, int PS, int NS, void* stream) {
  return launch(kv4_decode_kernel, dim3(KVH, B), q, q_bf16, k_q, k_s, v_q,
                v_s, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                pos, out, KVH, G, HD, PS, NS, stream);
}

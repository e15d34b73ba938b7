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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF (-2.0e38f)
#define THREADS 128

// One query group (the G heads of KV head h) at absolute position p over
// the pages named by `table` (NS entries); q and out at element offset
// qbase, (G, HD) each.
__device__ __noinline__ void paged_attention_query(
    const void* __restrict__ q, int q_bf16, long qbase,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale,
    const int32_t* __restrict__ table, int p, void* __restrict__ out,
    int KVH, int h, int G, int HD, int PS, int NS, float scale) {
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
    const long page = table[step];
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

// grid (KVH, B): q/out (B, KVH, G, HD), query position pos[b].
__global__ void kv4_paged_decode_kernel(
    const void* __restrict__ q, int q_bf16,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ pos,
    void* __restrict__ out, int KVH, int G, int HD, int PS, int NS,
    float scale) {
  const int b = blockIdx.y, h = blockIdx.x;
  paged_attention_query(q, q_bf16, ((long)b * KVH + h) * G * HD, k_pages,
                        k_scale, v_pages, v_scale, tables + (long)b * NS,
                        pos[b], out, KVH, h, G, HD, PS, NS, scale);
}

// grid (KVH, B, T): q/out (B, T, KVH, G, HD), query position pos[b] + t.
__global__ void kv4_paged_verify_kernel(
    const void* __restrict__ q, int q_bf16,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ pos,
    void* __restrict__ out, int KVH, int G, int HD, int PS, int NS,
    float scale) {
  const int b = blockIdx.y, h = blockIdx.x, t = blockIdx.z, T = gridDim.z;
  paged_attention_query(q, q_bf16, (((long)b * T + t) * KVH + h) * G * HD,
                        k_pages, k_scale, v_pages, v_scale,
                        tables + (long)b * NS, pos[b] + t, out, KVH, h, G,
                        HD, PS, NS, scale);
}

typedef void (*attention_kernel)(const void*, int, const int8_t*,
                                 const float*, const int8_t*, const float*,
                                 const int32_t*, const int32_t*, void*, int,
                                 int, int, int, int, float);

static int launch(attention_kernel kernel, dim3 grid, const void* q,
                  int q_bf16, const void* k_pages, const void* k_scale,
                  const void* v_pages, const void* v_scale,
                  const void* tables, const void* pos, void* out, int KVH,
                  int G, int HD, int PS, int NS, void* stream) {
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
      (const int8_t*)v_pages, (const float*)v_scale, (const int32_t*)tables,
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
                k_scale, v_pages, v_scale, tables, pos, out, KVH, G, HD, PS,
                NS, stream);
}

extern "C" int kv4_paged_verify_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int T, int KVH, int G, int HD,
    int PS, int NS, void* stream) {
  return launch(kv4_paged_verify_kernel, dim3(KVH, B, T), q, q_bf16,
                k_pages, k_scale, v_pages, v_scale, tables, pos, out, KVH,
                G, HD, PS, NS, stream);
}

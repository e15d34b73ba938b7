// Paged packed-KV4 flash-decode attention for Hopper (sm_90a): split-KV
// flash decoding, one thread-block cluster per query group.
//
// Replaces the Pallas kernels of `repro/kernels/kv_attention.py`:
//   kv4_paged_decode_attention (`_paged_kernel` -> `_flash_step` ->
//     `_dequant4_block` + `_flash_core`): one new query token per
//     sequence over its pages through the block table;
//   kv4_paged_verify_attention (`_paged_verify_kernel`): a T-token
//     window, token t a decode query at pos + t;
//   kv_tiered_paged_decode_attention (`_tiered_paged_kernel`): a page
//     whose tier id is 1 comes from the KV2 slab (P2, PS, KVH, HD/4),
//     four signed 2-bit fields a byte, field f of byte j = element 4j+f;
//   kv4_decode_attention (`_kernel`): the contiguous (B, S, KVH, HD/2)
//     cache read as pages of PS tokens, page i of sequence b = block i;
//     with a sliding window (gemma3's local layers; the Pallas kernel has
//     none, JAX's fixed-batch decode masks it in XLA) keys j with
//     pos - j < window only.
// K/V pages hold int4 nibbles two per byte along HD (byte j: element 2j
// low, 2j+1 high) and one f32 scale per (token, kv head). Semantics of
// `_flash_core`: f32 online softmax, scale HD**-0.5, NEG_INF = -2e38,
// causal mask i*PS + off <= pos, null page 0 for an inactive slot (pos
// 0, table row of zeros), pages after the one holding pos not read,
// drain acc / max(l, 1e-30) in q's dtype.
//
// Bound: bytes, (HD/2 + 4) * 2 a token and kv head, each page read once
// (KV2: (HD/4 + 4) * 2); about 4 * G * HD flops a token and kv head.
//
// Split plan, a pure function of the table width NS (WARPS = 4 warps a
// block, MAX_CLUSTER = 8 blocks a cluster):
//   ppw = ceil(NS / (WARPS * MAX_CLUSTER))   pages a warp
//   ppb = WARPS * ppw                         pages a block
//   cluster = ceil(NS / ppb)                  blocks a query group
// Page i belongs to block (cluster rank) i / ppb and, inside it, to warp
// (i % ppb) / ppw. For NS <= 32 a warp owns one page and the plan of a
// page does not depend on NS at all. It never depends on B, T, the grid
// or the tier table, so a verify call and T decode calls, a tiered call
// over tier-0 pages and a decode call, a contiguous call and a paged
// call on pages that tile its cache all split and merge alike and give
// the same bits (held on the card); only a sliding window whose start
// passes block 0 splits by its span's width instead (below).
// `kernels/kv_attention.py` `split_plan` and `window_span` mirror them
// and `tests/test_torch_attention_plan.py` tests them on the CPU.
//
// A block is one cluster rank of one query group (b[, t], kv head h, 4
// of its G query heads: ceil(G / 4) groups a kv head, the heads of the
// last group past G read zeros and are not written). Each warp walks its
// pages in tiles of 16 token rows (the QK MMA's M): a page of ps tokens
// is ceil(ps / 16) tiles, and the rows of a tile past the page's end
// load nothing, read as zeros and are masked. The body is a template on
// the head dim HD (16, 32, 64, 128 or 256: HD / 16 k-steps and m-tiles)
// and on PS, the page size: 16, the engine's, at compile time, or 0 for any
// other size read at run time (a separate instance, so the main path's
// loop keeps its constant trip counts). Each warp runs its own
// online-softmax state; no block barrier in the tile loop, and every warp
// runs the same number of iterations, so no shuffle sits in a branch the
// compiler cannot prove warp-uniform. Tiles arrive by cp.async into a
// per-warp ring of STAGES (two tiles in flight), rows padded so the
// fragment reads hit distinct banks. Both products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate): S^T = K Q^T with
// the 16 tokens as M and the 4 heads as N (8, half unused), P.V as O^T =
// V^T P^T with dims as M. A
// nibble (or 2-bit field) is exact in bf16: two of them become a bf16
// pair with one byte permute, one LOP3 (bf16 128 + (u ^ 8) by the magic
// exponent) and one bf16x2 subtract; the k order of QK and the row order
// of P.V are permuted so that each permute feeds two fragments (the low
// and the high nibbles of the same bytes). q and p are f32: each is
// split into three bf16 terms (24 bits) and multiplied in three MMAs, so
// the products of exact integers by q or p keep f32's precision; the
// block's q fragments live in shared memory, which keeps the registers
// at ~125 (4 blocks an SM). The K scale multiplies the finished dot
// product and the V scale the probability (p * vs), once per (token,
// head). Then the warps merge in warp order through shared memory (one
// barrier), and the cluster's blocks merge in rank order: rank r drains
// the outputs [r * per, (r + 1) * per) of the group (per = ceil(4 HD /
// cluster)), and every live rank pushes its partial of those outputs
// into rank r's shared memory (distributed shared memory stores) before
// the one cluster barrier. A block or warp whose first page lies past
// pos reads nothing and takes no part in a merge (its state would add
// exp(-2e38 - m) = 0 and multiply by exp(0) = 1, the same bits); a page
// past pos inside a live warp reads nothing, its scales are zeroed and
// its p is 0. No arrival counter: two calls in flight, or a CUDA graph,
// share nothing. An f32 (CUDA-core) body of the same plan, with the
// nibbles dequantized by the 2^23 magic number, took 8.0 and 48.6 us
// where this one takes 7.0 and 39.0 (smoke shape, ~4,096 tokens; H100,
// `PERF.md` PR 16).
//
// Sliding window (the contiguous kernel only; window 0 = none). Keys j
// with pos - window < j <= pos: a sequence reads only its blocks
// lo = max(0, pos - window + 1) / PS .. pos / PS, and masks the keys of
// block lo below the window's start. lo is computed on the device from
// pos (the fixed-batch decode replays as a CUDA graph). A sequence whose
// window starts past block 0 (lo > 0) splits its live blocks by the plan
// of the window's span, NSW = min(NS, (window + PS - 2) / PS + 1) blocks
// (the most a window can touch), block lo being the plan's page 0; one
// with lo = 0 keeps the plan of NS, so a window >= pos + 1 (lo = 0,
// nothing masked) gives window 0's bits. The launch takes the larger of
// the two plans' clusters; a rank past its sequence's plan is not live
// and drains nothing. So a window that binds reads min(pos + 1, window)
// tokens rounded out to whole blocks, spread over the whole cluster.
// A masked key's p is set to 0 outright (a tile wholly below the start
// may come first, while m is still NEG_INF); in window 0's paths that
// select changes no bit, their masked p being exp(-2e38 - m) = 0.
//
// HD 256 (paligemma-3b): the warps' cp.async rings (55,296 bytes) would
// take the block's static shared memory past 48 KB, so that instance
// keeps its rings in dynamic shared memory (opted in once a device with
// cudaFuncSetAttribute, at its first launch there: an eager call, before
// any graph capture); the instances up to HD 128 keep them static, as
// before.
// STAGES is not cut: one ring stage of HD 256 is 4,608 bytes, and even
// one stage would leave the static total past 48 KB.
//
// Float operations are spelled with the _rn intrinsics, so that no
// instance contracts a multiply and an add where another does not: the
// four kernels are instances of one template <HD, PS, TIERED,
// CONTIGUOUS, ROUND_KV>, decode and verify being one kernel (decode is
// T = 1).
// TIERED reads the tier table and the KV2 slab, CONTIGUOUS takes page
// `step` of the sequence's own cache; an earlier body that tested these
// at run time slowed the decode kernel by 8-11% on an H100, so they stay
// compile-time. ROUND_KV (the contiguous kernel only, JAX's fixed-batch
// decode at bf16) rounds each dequantized K and V element, nibble *
// scale, to bf16 before use, and then multiplies by the scale per
// element instead of folding it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NEG_INF (-2.0e38f)
#define FULL 0xffffffffu

constexpr int TR = 16;           // token rows a tile (the QK MMA's M)
constexpr int GQ = 4;            // query heads a block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int STAGES = 3;        // tiles a warp has in flight

// What HD fixes: k-steps of QK and m-tiles of P.V, the block's outputs,
// the bytes of a KV4 and a KV2 row and their cp.async chunks, and the
// words of a staged row, padded by 16 bytes so that the fragment reads
// of 4 or 8 rows fall in distinct banks (HD 128: 80 and 48 bytes).
template <int HD>
struct Shape {
  static_assert(HD % 16 == 0 && HD <= 256, "HD: 16, 32, 64, 128 or 256");
  static constexpr int KS = HD / 16;
  static constexpr int OUTS = GQ * HD;
  static constexpr int RB4 = HD / 2, RB2 = HD / 4;
  static constexpr int C4 = RB4 < 16 ? RB4 : 16, C2 = RB2 < 16 ? RB2 : 16;
  static constexpr int RW4 = HD / 8 + 4, RW2 = HD / 16 + 4;
  static constexpr int RING = 2 * TR * RW4;   // words a stage: K, V rows
  // the warps' rings in dynamic shared memory (above HD 128), their bytes
  static constexpr bool DYN = HD > 128;
  static constexpr int RING_BYTES = WARPS * STAGES * RING * 4;
};

struct Split {
  int ppw, ppb, cluster;
};

__host__ __device__ inline Split split_plan(int ns) {
  const int ppw = (ns + WARPS * MAX_CLUSTER - 1) / (WARPS * MAX_CLUSTER);
  const int ppb = WARPS * ppw;
  return {ppw, ppb, (ns + ppb - 1) / ppb};
}

// The most blocks of ps tokens that a window of `window` keys touches,
// at most the table's NS: the plan width of a windowed sequence.
__host__ __device__ inline int window_span(int ns, int ps, int window) {
  return min(ns, (window + ps - 2) / ps + 1);
}

// A block's first access to another block's shared memory must follow
// that block's start: each block arrives (relaxed) when it starts and
// waits just before its first remote store.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// D += A B on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two signed nibbles (KV4) or 2-bit fields (KV2) at bits 0.. and 16.. of
// t as a bf16 pair, exactly: bf16 128 + (u ^ 8) less 136 (128 + (u ^ 2)
// less 130).
template <bool KV2>
__device__ __forceinline__ uint32_t to_bf16x2(uint32_t t) {
  const uint32_t u = KV2 ? (t & 0x00030003u) ^ 0x43024302u
                         : (t & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t off = KV2 ? 0x43024302u : 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
              *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ROUND_KV: the pair times its scales, each product rounded to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s_lo,
                                                 float s_hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(f.x, s_lo),
                                                 __fmul_rn(f.y, s_hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// An f32 value as three bf16 terms, v = h0 + h1 + h2 to f32's precision,
// so that a bf16 MMA of exact integers reproduces the f32 product sum.
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&h)[3]) {
  h[0] = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(h[0]));
  h[1] = __float2bfloat16_rn(r1);
  h[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h[1])));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}

// Rows [0, nrows) of one tile of one kv head (K rows then V rows, RB
// bytes each from `row0` of the slab, rows KVH * RB bytes apart) into a
// ring stage whose rows are RW words apart, in chunks of C bytes.
template <int RB, int C, int RW, int V_AT>
__device__ __forceinline__ void stage_rows(uint32_t* ring, const int8_t* kp,
                                           const int8_t* vp, long row0,
                                           int KVH, int nrows, int lane) {
  constexpr int CPR = RB / C;                 // chunks a row
  static_assert((2 * TR * CPR) % 32 == 0, "whole warp passes");
#pragma unroll
  for (int c0 = 0; c0 < 2 * TR * CPR; c0 += 32) {
    const int c = c0 + lane;
    const int kv = c / (TR * CPR), r = (c / CPR) % TR, col = c % CPR;
    if (r < nrows)
      cp_async<C>(ring + kv * V_AT + r * RW + col * (C / 4),
                  (kv ? vp : kp) + (row0 + (long)r * KVH) * RB + col * C);
  }
}

#define PAGED_ARGS                                                         \
    const void* __restrict__ q, int q_bf16,                                \
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale, \
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale, \
    const int8_t* __restrict__ k2_pages,                                   \
    const float* __restrict__ k2_scale,                                    \
    const int8_t* __restrict__ v2_pages,                                   \
    const float* __restrict__ v2_scale,                                    \
    const int32_t* __restrict__ tables, const int32_t* __restrict__ tiers, \
    const int32_t* __restrict__ pos, void* __restrict__ out, int T,        \
    int KVH, int G, int ps_rt, int NS, int window, float scale

// grid (cluster, KVH * ceil(G/GQ), B * T), cluster (cluster, 1, 1);
// q/out (B, T, KVH, G, HD), query position pos[b] + t; pages of PS
// tokens (PS = 0: ps_rt). The contiguous cache is (B, NS * ps, KVH,
// HD/2) and its scales (B, NS * ps, KVH); `window` is read only there.
template <int HD, int PS, bool TIERED, bool CONTIGUOUS, bool ROUND_KV>
__global__ void __launch_bounds__(THREADS)
attention_kernel(PAGED_ARGS) {
  using SH = Shape<HD>;
  constexpr int KS = SH::KS, OUTS = SH::OUTS;
  constexpr int RW4 = SH::RW4, RW2 = SH::RW2, V_AT = TR * RW4;
  __shared__ float acc_w[WARPS][OUTS];
  // a warp's ring of STAGES tiles in flight: K rows then V rows, 16 rows
  // of RW4 (KV2: RW2) words each, warp w's stage st at (w STAGES + st)
  // RING; static up to HD 128, dynamic above; and their K and V scales
  __shared__ __align__(16) uint32_t
      kv_ring_s[SH::DYN ? 4 : WARPS * STAGES * SH::RING];
  extern __shared__ __align__(16) uint32_t kv_ring_d[];
  uint32_t* const kv_ring = SH::DYN ? kv_ring_d : kv_ring_s;
  // Q^T as the QK MMA's B fragments, three bf16 terms of each f32 q, one
  // word a lane: shared by the block's warps, out of their registers
  __shared__ uint32_t q_frag[3][KS][2][32];
  __shared__ float sc_ring[WARPS][STAGES][2 * TR];
  __shared__ float m_w[WARPS][GQ], l_w[WARPS][GQ];
  // the cluster's partials of the outputs this block drains, pushed
  // here by every live rank: rank b's at in_acc[b * per + local output]
  __shared__ float in_acc[OUTS + MAX_CLUSTER], in_m[MAX_CLUSTER][GQ],
      in_l[MAX_CLUSTER][GQ];

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = (int)cluster.block_rank();
  const int ps = PS ? PS : ps_rt;
  const int tpp = (ps + TR - 1) / TR;           // tiles a page
  const int GS = (G + GQ - 1) / GQ;
  const int h = blockIdx.y / GS, gs = blockIdx.y % GS;
  const int nh = min(GQ, G - gs * GQ);          // the block's live heads
  const int b = blockIdx.z / T, t = blockIdx.z % T;
  const int p = pos[b] + t;
  const int last = min(max(p, 0) / ps, NS - 1);
  // a window's first key and first block lo; the plan's page slots are
  // blocks lo + i, live up to last_v (window 0: lo = 0, start 0), split
  // by the window span's plan when lo > 0, else by NS's
  const bool windowed = CONTIGUOUS && window > 0;
  const int start = windowed ? p - window + 1 : 0;
  const int lo = windowed ? min(max(start, 0) / ps, last) : 0;
  const int last_v = last - lo;
  const Split sp = split_plan(lo > 0 ? window_span(NS, ps, window) : NS);
  const long qbase = ((((long)b * T + t) * KVH + h) * G + gs * GQ) * HD;
  const int32_t* table = CONTIGUOUS ? nullptr : tables + (long)b * NS;
  const int32_t* tier = TIERED ? tiers + (long)b * NS : nullptr;
  if (CONTIGUOUS) {                       // sequence b's own cache
    const long seq = (long)b * NS * ps * KVH;
    k_pages += seq * (HD / 2);
    v_pages += seq * (HD / 2);
    k_scale += seq;
    v_scale += seq;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bstart = rank * sp.ppb;
  const bool block_live = bstart <= last_v;

  // Every warp runs sp.ppw * tpp tile iterations, a number the whole grid
  // shares (a windowed call: all of a sequence's blocks): no shuffle sits
  // in a branch the compiler cannot prove warp-uniform (it would wrap
  // each in a collective). A page past pos,
  // or past the table, loads nothing, reads as zeros and is masked.
  const int first = bstart + warp * sp.ppw;
  const int n_it = sp.ppw * tpp;
  {
    // fragment coordinates (mma m16n8k16): g = lane >> 2, t = lane & 3.
    // QK: S^T (16 tokens x 8 heads, heads 4-7 zero) = K (16 x HD) Q^T;
    // P.V: O^T (HD dims x 8 heads) = V^T (HD x 16 tokens) P^T.
    const int g = lane >> 2, t = lane & 3;
    // Q^T as B fragments, three bf16 terms of each f32 q: column g is
    // head g (zero past the block's live heads), rows k = 2t, 2t + 1 (b0)
    // and + 8 (b1); warp w fills k-steps w, w + WARPS, ... (a loop of
    // constant trip count: its loads issue together)
#pragma unroll
    for (int kw = 0; kw < (KS + WARPS - 1) / WARPS; ++kw)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = kw * WARPS + warp;
        if (KS % WARPS != 0 && kk >= KS) continue;
        __nv_bfloat16 lo[3], hi[3];
        float v[2] = {0.0f, 0.0f};
        if (g < nh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long at = qbase + g * HD + 16 * kk + 4 * t + half + 2 * e;
            v[e] = q_bf16 ? __bfloat162float(
                                reinterpret_cast<const __nv_bfloat16*>(q)[at])
                          : reinterpret_cast<const float*>(q)[at];
          }
        }
        split3(v[0], lo);
        split3(v[1], hi);
#pragma unroll
        for (int sp3 = 0; sp3 < 3; ++sp3)
          q_frag[sp3][kk][half][lane] = pack_bf16x2(lo[sp3], hi[sp3]);
      }
    __syncthreads();
    // O^T accumulators: m-tile mt rows g, g + 8 (dims 16 mt + 2g, + 1),
    // columns heads 2t, 2t + 1; m, l of heads 2t + e
    float acc[KS][4], m[2], l[2];
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.0f;

    // tile `it` of the warp (page first + it / tpp, rows from (it % tpp)
    // * 16) into ring stage st by cp.async, and one scale a lane (K for
    // l < 16, V above); a page past pos copies nothing, and rows past the
    // page's end nothing either: their scales are zeroed, so that their
    // masked p and stale rows add exact zeros
    auto issue = [&](int it, int st) {
      const int step = first + it / tpp, row0 = (it % tpp) * TR;
      uint32_t* ring = kv_ring + (warp * STAGES + st) * SH::RING;
      float* sc = sc_ring[warp][st];
      if (step <= last_v) {
        const int nrows = min(TR, ps - row0);
        const long page = CONTIGUOUS ? lo + step : __ldg(table + step);
        const bool kv2 = TIERED && __ldg(tier + step) == 1;
        const long tok0 = (page * ps + row0) * KVH + h;   // the tile's row 0
        if (kv2)
          stage_rows<SH::RB2, SH::C2, RW2, V_AT>(ring, k2_pages, v2_pages,
                                                 tok0, KVH, nrows, lane);
        else
          stage_rows<SH::RB4, SH::C4, RW4, V_AT>(ring, k_pages, v_pages,
                                                 tok0, KVH, nrows, lane);
        const int r = lane % TR;
        if (r < nrows)
          cp_async<4>(&sc[lane], (lane < TR ? (kv2 ? k2_scale : k_scale)
                                            : (kv2 ? v2_scale : v_scale)) +
                                     tok0 + (long)r * KVH);
        else
          sc[lane] = 0.0f;
      } else {
        sc[lane] = 0.0f;
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_it) issue(i, i);
      else asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES;
      if (it + STAGES - 1 < n_it)
        issue(it + STAGES - 1, (it + STAGES - 1) % STAGES);
      else
        asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
      __syncwarp();                         // the tile's copies landed
      const int step = first + it / tpp, row0 = (it % tpp) * TR;
      const int nrows = min(TR, ps - row0);
      const bool kv2 = TIERED && step <= last_v && __ldg(tier + step) == 1;
      const int rs = kv2 ? RW2 : RW4;
      const uint32_t* k_rows = kv_ring + (warp * STAGES + st) * SH::RING;
      const uint32_t* v_rows = k_rows + V_AT;
      const float* scl = sc_ring[warp][st];   // ks[16], vs[16]

      // S^T = K Q^T: A rows g, g + 8 are tokens; a k-step is 16 dims.
      // Six accumulators (q term x k-step parity) keep the MMA chains
      // short; they add up in a fixed order below.
      float sc6[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc6[i][j] = 0.0f;
      {
        const uint32_t* r0 = k_rows + g * rs;
        const uint32_t* r1 = k_rows + (g + 8) * rs;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4];
          if (kv2) {
            // dims 16 kk + 4t .. + 3 are the 4 fields of byte t of word
            // kk: fields 0, 2 to (a0, a1), fields 1, 3 to (a2, a3)
            const uint32_t sel = t | ((4 + t) << 8);
            const uint32_t u0 = __byte_perm(r0[kk], r0[kk] >> 4, sel);
            const uint32_t u1 = __byte_perm(r1[kk], r1[kk] >> 4, sel);
            a[0] = to_bf16x2<true>(u0);
            a[1] = to_bf16x2<true>(u1);
            a[2] = to_bf16x2<true>(u0 >> 2);
            a[3] = to_bf16x2<true>(u1 >> 2);
          } else {
            // dims 16 kk + 4t .. + 3 are bytes 2 (t & 1), + 1 of word
            // 2 kk + (t >> 1): low nibbles to (a0, a1), high to (a2, a3)
            const int wd = 2 * kk + (t >> 1), b = 2 * (t & 1);
            const uint32_t sel = b | ((b + 1) << 8);
            const uint32_t u0 = __byte_perm(r0[wd], 0u, sel);
            const uint32_t u1 = __byte_perm(r1[wd], 0u, sel);
            a[0] = to_bf16x2<false>(u0);
            a[1] = to_bf16x2<false>(u1);
            a[2] = to_bf16x2<false>(u0 >> 4);
            a[3] = to_bf16x2<false>(u1 >> 4);
            if (ROUND_KV) {
              a[0] = scale_bf16x2(a[0], scl[g], scl[g]);
              a[1] = scale_bf16x2(a[1], scl[g + 8], scl[g + 8]);
              a[2] = scale_bf16x2(a[2], scl[g], scl[g]);
              a[3] = scale_bf16x2(a[3], scl[g + 8], scl[g + 8]);
            }
          }
#pragma unroll
          for (int sp3 = 0; sp3 < 3; ++sp3)
            mma_bf16(sc6[2 * sp3 + (kk & 1)], a[0], a[1], a[2], a[3],
                     q_frag[sp3][kk][0][lane], q_frag[sp3][kk][1][lane]);
        }
      }
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[j] = __fadd_rn(__fadd_rn(__fadd_rn(sc6[0][j], sc6[1][j]),
                                    __fadd_rn(sc6[2][j], sc6[3][j])),
                          __fadd_rn(sc6[4][j], sc6[5][j]));
      // scores: sc[2 i + e] is token g + 8 i, head 2t + e
      float s[4];
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tok = g + 8 * i;
        const int at = (lo + step) * ps + row0 + tok;   // the key's position
        live[i] = step <= last_v && tok < nrows && at <= p &&
                  (!windowed || at >= start);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dot = ROUND_KV ? sc[2 * i + e]
                                     : __fmul_rn(sc[2 * i + e], scl[tok]);
          s[2 * i + e] = live[i] ? __fmul_rn(dot, scale) : NEG_INF;
        }
      }
      // online softmax of heads 2t, 2t + 1 over the tile's 16 tokens (the
      // 8 lanes g of a column, 2 tokens each)
      float corr[2], pr[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(s[e], s[2 + e]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float mn = fmaxf(m[e], mx);
        corr[e] = expf(__fsub_rn(m[e], mn));
        pr[e] = expf(__fsub_rn(s[e], mn));
        pr[2 + e] = expf(__fsub_rn(s[2 + e], mn));
        if (CONTIGUOUS) {           // a masked key adds nothing (see top)
          pr[e] = live[0] ? pr[e] : 0.0f;
          pr[2 + e] = live[1] ? pr[2 + e] : 0.0f;
        }
        float sum = __fadd_rn(pr[e], pr[2 + e]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
        l[e] = __fadd_rn(__fmul_rn(l[e], corr[e]), sum);
        m[e] = mn;
        if (corr[e] != 1.0f) {
#pragma unroll
          for (int mt = 0; mt < KS; ++mt) {
            acc[mt][e] = __fmul_rn(acc[mt][e], corr[e]);
            acc[mt][2 + e] = __fmul_rn(acc[mt][2 + e], corr[e]);
          }
        }
      }
      // p (times the V scale) to P^T B fragments: column g is head g,
      // rows are tokens 2t, 2t + 1 (b0) and + 8 (b1); p of token u, head
      // h sits in lane (u & 7) * 4 + (h >> 1), register 2 (u >> 3) +
      // (h & 1)
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = ROUND_KV ? pr[i]
                         : __fmul_rn(pr[i], scl[TR + g + 8 * (i >> 1)]);
      uint32_t pb[3][2];
      {
        float pt[4];                        // tokens 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int src = (2 * t + j) * 4 + (g >> 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float v0 = __shfl_sync(FULL, pv[2 * i], src);
            const float v1 = __shfl_sync(FULL, pv[2 * i + 1], src);
            pt[2 * i + j] = (g & 1) ? v1 : v0;
          }
        }
        __nv_bfloat16 hb[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i) split3(pt[i], hb[i]);
#pragma unroll
        for (int sp3 = 0; sp3 < 3; ++sp3) {
          pb[sp3][0] = pack_bf16x2(hb[0][sp3], hb[1][sp3]);
          pb[sp3][1] = pack_bf16x2(hb[2][sp3], hb[3][sp3]);
        }
      }
      // O^T += V^T P^T: A rows g, g + 8 are dims 16 mt + 2g, + 1;
      // columns tokens 2t, 2t + 1 (a0, a1) and + 8 (a2, a3)
      {
        const uint32_t* rw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[i] = v_rows + (2 * t + (i & 1) + 8 * (i >> 1)) * rs;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          uint32_t a[4];
          if (kv2) {
            // rows g, g + 8 are dims 16 mt + 2g, + 1: fields 2 (g & 1),
            // + 1 of byte g >> 1 of word mt
            const int sh = 4 * (g & 1);
            const uint32_t sel = (g >> 1) | ((4 + (g >> 1)) << 8);
            const uint32_t u0 = __byte_perm(rw[0][mt] >> sh, rw[1][mt] >> sh,
                                            sel);
            const uint32_t u1 = __byte_perm(rw[2][mt] >> sh, rw[3][mt] >> sh,
                                            sel);
            a[0] = to_bf16x2<true>(u0);
            a[1] = to_bf16x2<true>(u0 >> 2);
            a[2] = to_bf16x2<true>(u1);
            a[3] = to_bf16x2<true>(u1 >> 2);
          } else {
            // rows g, g + 8 are dims 16 mt + 2g, + 1: the low and high
            // nibble of byte g & 3 of word 2 mt + (g >> 2)
            const int wd = 2 * mt + (g >> 2);
            const uint32_t sel = (g & 3) | ((4 + (g & 3)) << 8);
            const uint32_t u0 = __byte_perm(rw[0][wd], rw[1][wd], sel);
            const uint32_t u1 = __byte_perm(rw[2][wd], rw[3][wd], sel);
            a[0] = to_bf16x2<false>(u0);
            a[1] = to_bf16x2<false>(u0 >> 4);
            a[2] = to_bf16x2<false>(u1);
            a[3] = to_bf16x2<false>(u1 >> 4);
            if (ROUND_KV) {
              const float* vst = scl + TR + 2 * t;
              a[0] = scale_bf16x2(a[0], vst[0], vst[1]);
              a[1] = scale_bf16x2(a[1], vst[0], vst[1]);
              a[2] = scale_bf16x2(a[2], vst[8], vst[9]);
              a[3] = scale_bf16x2(a[3], vst[8], vst[9]);
            }
          }
#pragma unroll
          for (int sp3 = 0; sp3 < 3; ++sp3)
            mma_bf16(acc[mt], a[0], a[1], a[2], a[3], pb[sp3][0],
                     pb[sp3][1]);
        }
      }
      __syncwarp();                 // the stage's reads done before reuse
    }
    // heads 2t + e of the lanes t < 2 are the block's 4 query heads;
    // rows g, g + 8 of m-tile mt are dims 16 mt + 2g, + 1
    if (t < 2) {
#pragma unroll
      for (int mt = 0; mt < KS; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc_w[warp][(2 * t + e) * HD + 16 * mt + 2 * g] = acc[mt][e];
          acc_w[warp][(2 * t + e) * HD + 16 * mt + 2 * g + 1] =
              acc[mt][2 + e];
        }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m_w[warp][2 * t + e] = m[e];
          l_w[warp][2 * t + e] = l[e];
        }
      }
    }
  }
  __syncthreads();
  // rank r drains the outputs [r * per, (r + 1) * per) of the group
  const int per = (OUTS + sp.cluster - 1) / sp.cluster;
  cluster_wait();                   // every block of the cluster started
  if (block_live) {
    // the live warps' states in warp order: the block's partial, pushed
    // to the rank that drains each output
    const int nw = min(WARPS, (last_v - bstart) / sp.ppw + 1);
    for (int o = threadIdx.x; o < OUTS; o += THREADS) {
      const int g = o / HD;
      float mm = m_w[0][g], ll = l_w[0][g], aa = acc_w[0][o];
      for (int wi = 1; wi < nw; ++wi) {
        const float mw = m_w[wi][g];
        const float mn = fmaxf(mm, mw);
        const float ca = expf(__fsub_rn(mm, mn));
        const float cb = expf(__fsub_rn(mw, mn));
        ll = __fadd_rn(__fmul_rn(ll, ca), __fmul_rn(l_w[wi][g], cb));
        aa = __fadd_rn(__fmul_rn(aa, ca), __fmul_rn(acc_w[wi][o], cb));
        mm = mn;
      }
      const int dst = o / per;
      *cluster.map_shared_rank(&in_acc[rank * per + o - dst * per], dst) = aa;
      if (o % HD == 0) {
        for (int d = 0; d < sp.cluster; ++d) {
          *cluster.map_shared_rank(&in_m[rank][g], d) = mm;
          *cluster.map_shared_rank(&in_l[rank][g], d) = ll;
        }
      }
    }
  }
  cluster.sync();   // the pushes landed; nothing remote is read after this
  // the live ranks' partials in rank order; heads past G are not written
  const int live_ranks = last_v / sp.ppb + 1;
  const int o_end = min(nh * HD, (rank + 1) * per);
  for (int o = rank * per + threadIdx.x; o < o_end; o += THREADS) {
    const int g = o / HD, ol = o - rank * per;
    float mm = in_m[0][g], ll = in_l[0][g], aa = in_acc[ol];
    for (int ri = 1; ri < live_ranks; ++ri) {
      const float mr = in_m[ri][g];
      const float mn = fmaxf(mm, mr);
      const float ca = expf(__fsub_rn(mm, mn));
      const float cb = expf(__fsub_rn(mr, mn));
      ll = __fadd_rn(__fmul_rn(ll, ca), __fmul_rn(in_l[ri][g], cb));
      aa = __fadd_rn(__fmul_rn(aa, ca), __fmul_rn(in_acc[ri * per + ol], cb));
      mm = mn;
    }
    const float res = __fdiv_rn(aa, fmaxf(ll, 1e-30f));
    if (q_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[qbase + o] =
          __float2bfloat16_rn(res);
    else
      reinterpret_cast<float*>(out)[qbase + o] = res;
  }
}

// The devices whose hd-256 opt-in launch_as remembers (the attribute is
// set on the current device's context); a device past them sets it at
// every launch.
constexpr int MAX_DEVICES = 64;

// The operands of one call: the paged kernels read k2/v2 and the tier
// table only in their TIERED instance, the table not in CONTIGUOUS.
struct Call {
  const void *q, *k_pages, *k_scale, *v_pages, *v_scale, *k2_pages,
      *k2_scale, *v2_pages, *v2_scale, *tables, *tiers, *pos;
  void* out;
  int q_bf16, B, T, KVH, G, hd, ps, NS, window;
  void* stream;
};

template <int HD, int PS, bool TIERED, bool CONTIGUOUS, bool ROUND_KV>
static int launch_as(const Call& c) {
  using SH = Shape<HD>;
  auto kernel = attention_kernel<HD, PS, TIERED, CONTIGUOUS, ROUND_KV>;
  if (SH::DYN) {        // once an instance and device, before its first use
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SH::RING_BYTES);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  // the larger of the two plans' clusters a windowed call may split by
  int cluster = split_plan(c.NS).cluster;
  if (c.window > 0)
    cluster = max(cluster,
                  split_plan(window_span(c.NS, c.ps, c.window)).cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, c.KVH * ((c.G + GQ - 1) / GQ), c.B * c.T);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SH::DYN ? SH::RING_BYTES : 0;
  cfg.stream = (cudaStream_t)c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, c.q,
      c.q_bf16, (const int8_t*)c.k_pages, (const float*)c.k_scale,
      (const int8_t*)c.v_pages, (const float*)c.v_scale,
      (const int8_t*)c.k2_pages, (const float*)c.k2_scale,
      (const int8_t*)c.v2_pages, (const float*)c.v2_scale,
      (const int32_t*)c.tables, (const int32_t*)c.tiers,
      (const int32_t*)c.pos, c.out, c.T, c.KVH, c.G, c.ps, c.NS, c.window,
      (float)pow((double)HD, -0.5));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int PS, bool TIERED, bool CONTIGUOUS, bool ROUND_KV>
static int launch_hd(const Call& c) {
  switch (c.hd) {
    case 16: return launch_as<16, PS, TIERED, CONTIGUOUS, ROUND_KV>(c);
    case 32: return launch_as<32, PS, TIERED, CONTIGUOUS, ROUND_KV>(c);
    case 64: return launch_as<64, PS, TIERED, CONTIGUOUS, ROUND_KV>(c);
    case 128: return launch_as<128, PS, TIERED, CONTIGUOUS, ROUND_KV>(c);
    case 256: return launch_as<256, PS, TIERED, CONTIGUOUS, ROUND_KV>(c);
  }
  return (int)cudaErrorInvalidValue;
}

// pages of 16 tokens run the compile-time instance, any other size the
// run-time one
template <bool TIERED, bool CONTIGUOUS, bool ROUND_KV>
static int launch(const Call& c) {
  if (c.G < 1 || c.ps < 1 || c.NS < 1 || c.window < 0)
    return (int)cudaErrorInvalidValue;
  return c.ps == TR ? launch_hd<TR, TIERED, CONTIGUOUS, ROUND_KV>(c)
                    : launch_hd<0, TIERED, CONTIGUOUS, ROUND_KV>(c);
}

extern "C" int kv4_paged_decode_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int KVH, int G, int hd, int ps,
    int NS, void* stream) {
  return launch<false, false, false>(
      {q, k_pages, k_scale, v_pages, v_scale, nullptr, nullptr, nullptr,
       nullptr, tables, nullptr, pos, out, q_bf16, B, 1, KVH, G, hd, ps, NS,
       0, stream});
}

// the decode kernel with T window tokens a sequence
extern "C" int kv4_paged_verify_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* tables,
    const void* pos, void* out, int B, int T, int KVH, int G, int hd,
    int ps, int NS, void* stream) {
  return launch<false, false, false>(
      {q, k_pages, k_scale, v_pages, v_scale, nullptr, nullptr, nullptr,
       nullptr, tables, nullptr, pos, out, q_bf16, B, T, KVH, G, hd, ps, NS,
       0, stream});
}

extern "C" int kv_tiered_paged_decode_launch(
    const void* q, int q_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* k2_pages,
    const void* k2_scale, const void* v2_pages, const void* v2_scale,
    const void* tables, const void* tiers, const void* pos, void* out,
    int B, int KVH, int G, int hd, int ps, int NS, void* stream) {
  return launch<true, false, false>(
      {q, k_pages, k_scale, v_pages, v_scale, k2_pages, k2_scale, v2_pages,
       v2_scale, tables, tiers, pos, out, q_bf16, B, 1, KVH, G, hd, ps, NS,
       0, stream});
}

// k_q/v_q (B, S, KVH, HD/2), k_s/v_s (B, S, KVH), S = NS * ps; a
// sliding window of `window` keys (0: none).
extern "C" int kv4_decode_launch(
    const void* q, int q_bf16, const void* k_q, const void* k_s,
    const void* v_q, const void* v_s, const void* pos, void* out, int B,
    int KVH, int G, int hd, int ps, int NS, int round_kv, int window,
    void* stream) {
  const Call c{q, k_q, k_s, v_q, v_s, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, pos, out, q_bf16, B, 1, KVH, G, hd, ps, NS,
               window, stream};
  if (round_kv && q_bf16) return launch<false, true, true>(c);
  return launch<false, true, false>(c);
}

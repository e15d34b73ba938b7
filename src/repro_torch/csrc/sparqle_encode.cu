// SPARQLe drain encoder for Hopper (sm_90a): one CUDA body for the
// encoder, its quantize-only form and its packed form, each with the
// per-token scale computed in the kernel or taken as an input.
//
// Replaces the Pallas kernels `repro/kernels/sparqle_encode.py`
// `sparqle_encode` (`_kernel`, `_quantize`) and `sparqle_encode_packed`
// (`_kernel_packed`). Per element of x (M, K):
//   q = clamp(rint(x / scale_row), -128, 127)  (quotient rounded to bf16
//       first when x is bf16, as the serving path forms it in x's dtype)
//   optional serve-time clip on masked columns: [l, 0) -> 0, (15, h] -> 15
//   lsb = q & 0xF, msb = q >> 4, pbm = msb != 0 (not stored when pbm
//   is null: the serving linear reads only the tile populations)
// and the PBM population of each (TILE_M, TILE_K) tile, which the
// dual-pass matmul reads to skip its MSB pass. Three modes:
//   MODE_ENCODE: lsb and msb int8 (M, K), pbm uint8 (M, K) or none;
//   MODE_QUANTIZE: the clipped int8 q alone, no populations (the dense
//     W4A8 baseline's single-pass matmul reads it); one per-element
//     function, so q = 16 * msb + lsb of the encoder bit for bit;
//   MODE_PACKED: the wire layout of `core/packing.py` with K padded to
//     KP = a multiple of 32 (padded columns encode as 0, PBM 0): LSB4
//     and MSB4 two per byte (M, KP/2) -- byte j holds column 2j low and
//     2j+1 high -- and the PBM in 32-bit words (M, KP/32), bit i of word
//     w = column 32w + i; a lane's 8 columns are 4 bytes of each plane
//     (one 32-bit store each) and one byte of a PBM word, and the 4
//     lanes that share a word OR their bytes with two shuffles.
//
// The `*_fused_launch` entries compute the per-token scale themselves
// and write it, (M, 1) f32, beside the planes: one launch where the
// serving linear ran abs, amax, div, clamp_min and a cast before each
// encoder. The scale is `token_scale`: max(amax / 127, 1e-8) in x's
// dtype (for bf16 the f32 quotient and the bound rounded to bf16, which
// is torch's and JAX's bf16 division and clamp), then f32 -- bit for bit
// `core/quantize.py` `activation_scale(x).float()` and JAX's
// `quantize_activations` scale. The other entries take the scale as an
// input (SCALE_IN), as the Pallas kernels do; a tensor-parallel caller
// passes one formed from an all-reduced amax.
//
// Bound: bytes (x read once, 2 or 4 B/elem; 1-3 B/elem out plus one
// int32 a tile), but at the serving shapes (8 rows at decode, one row
// an expert) a call moves ~100 KB, so latency and the per-element
// arithmetic (a division, two roundings, the clip and the split) bound
// it. The design spreads the arithmetic over many SMs, keeps one round
// trip to memory and no branch inside a lane's 8 elements:
// - The plan (`kernels/sparqle_encode.py` `fused_plan`, passed in as
//   `Plan`, a function of the shapes alone) gives a block R rows (the
//   live rows of its TILE_M-row group: min(M, 16) rounded up to a power
//   of two, so no warp holds rows past M at decode) and W warps a row,
//   and splits K over S blocks, S chosen to fill the card; with the
//   scale computed here, the S blocks of a row group form one
//   thread-block cluster (S <= 16).
// - x is read once from device memory with 16-byte loads straight into
//   registers: lane l of warp w holds chunks of 8 columns, chunk
//   ((p J + j) W + w) 32 + l of the block's slice in pass p. The row's
//   amax is reduced in the warp (one redux), then across its W warps
//   through shared memory (one block barrier) or, in a cluster, each
//   warp's pushed to every block of the cluster through distributed
//   shared memory (st.async onto each block's mbarrier, after one cluster
//   barrier that the loads overlap): no block reads a row another block
//   reads.
// - Each lane quantizes the chunks it holds (the division as `Divisor`:
//   correctly rounded, branch-free) and stores the planes (8-byte
//   stores; the packed layout's shuffles); a tile is 16 chunks, half a
//   warp, whose count is summed in the warp (redux) and added to the
//   tile's population, zeroed by the block that owns the tile.
// - Where a block's share of a row is wider than its lanes hold in
//   registers (J <= 4 bf16 or 2 f32 chunks: 64 B of x a lane), the
//   block walks it in P passes, each pass but the last kept in shared
//   memory as it is read (the wide fused calls: K > 16,384 at M >= 16).
// The entries that take the scale need no amax: their K is split over
// as many blocks as its width needs, any K, no cluster.
// On an H100 (`PERF.md`, PR 33): __fdiv_rn's slow-path branch kept a
// lane's elements apart; a cluster.sync() after the pushes cost more at
// decode than st.async onto an mbarrier readied under the loads (with a
// relaxed arrive: a release one waits for the loads); the clip as
// selects instead of branches was slower; a body several times the
// parent's code ran slower inside a decode step than alone.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TILE_M 16
#define TILE_K 128
#define CHUNK 8                        // columns a lane encodes at once
#define TILE_CHUNKS (TILE_K / CHUNK)   // 16: half a warp
#define MAX_THREADS 512
#define MAX_CLUSTER 16
#define MAX_SMEM (227 * 1024)

// round(x / s) clipped to int8, then the serve-time clip on a masked
// column: [l, 0) -> 0, (15, h] -> 15.
// the quotient v = x / s -> round (to bf16 first for a bf16 x) -> int8
// -> clip
__device__ __forceinline__ int round_clip(float v, int x_bf16, bool masked,
                                          int clip_l, int clip_h) {
  if (x_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  v = fminf(fmaxf(rintf(v), -128.0f), 127.0f);
  int q = (int)v;
  if (masked) {
    if (q >= clip_l && q < 0) q = 0;
    else if (q > 15 && q <= clip_h) q = 15;
  }
  return q;
}

// x / s rounded to nearest, as __fdiv_rn gives it, without its slow-path
// branch (which keeps a lane's 8 divisions from overlapping): y = RN(1/s)
// once a row, then the product and two corrections whose residuals the
// fma forms exactly. The first brings the quotient within an ulp, and
// the second then rounds correctly (Markstein's theorem: y within half an
// ulp of 1/s, q within an ulp of x/s => RN(q + (x - q s) y) = RN(x/s)),
// while 2^-100 <= |s| <= 2^100 and the quotient is normal. Only its
// integer survives (rint, clamp to int8), so a quotient below 2^-100 or
// past the clamp needs no more; a non-finite product or first correction
// (x inf or NaN, or the quotient at FLT_MAX) passes through with the
// sign of __fdiv_rn's. A row whose
// scale lies outside takes __fdiv_rn itself (`fast` false).
struct Divisor {
  float s, y;
  bool fast;
};

__device__ __forceinline__ Divisor make_divisor(float s) {
  const float a = fabsf(s);
  return {s, __frcp_rn(s), a >= 0x1p-100f && a <= 0x1p100f};
}

__device__ __forceinline__ float divide_fast(float x, const Divisor& d) {
  const float q0 = __fmul_rn(x, d.y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, d.s, x), d.y, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-q1, d.s, x), d.y, q1);
  // a product or a first correction past FLT_MAX is the quotient's inf
  // (a later residual of it would be NaN)
  return isfinite(q0) ? (isfinite(q1) ? q2 : q1) : q0;
}

__device__ __forceinline__ float guard_scale(float s) {
  return fabsf(s) < 1.17549435e-38f ? 1.0f : s;   // f32 tiny: degenerate
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// activation_scale(x).float(): max(amax / 127, 1e-8) in x's dtype; a NaN
// quotient passes through, as torch.clamp_min lets it
__device__ __forceinline__ float token_scale(float amax, int x_bf16) {
  float v = __fdiv_rn(amax, 127.0f);
  float lo = 1e-8f;
  if (x_bf16) {
    v = bf16_round(v);
    lo = bf16_round(lo);
  }
  return v < lo ? lo : v;
}

#define MODE_ENCODE 0
#define MODE_QUANTIZE 1
#define MODE_PACKED 2

// The launch plan (`kernels/sparqle_encode.py` `FusedPlan`): R rows a
// block (a power of two, at least the rows of a row group), `tiles`
// TILE_K tiles a block (S = ceil(n_kt / tiles) blocks a row group), W
// warps a row, J chunks a lane a pass, P passes.
struct Plan {
  int rows, tiles, warps, chunks, passes;
};

// uint4s of x a chunk of 8 columns, and chunks a lane holds a pass
template <bool XBF16> struct Width {
  static constexpr int CW = XBF16 ? 1 : 2;
  static constexpr int JMAX = XBF16 ? 4 : 2;
};

// Dynamic shared memory: the staged passes (all but the last), a chunk a
// thread each, in thread order.
__host__ __device__ inline size_t plan_smem(const Plan& p, int x_bf16) {
  const int threads = p.rows * p.warps * 32;
  return (size_t)(p.passes - 1) * p.chunks * threads * (x_bf16 ? 16 : 32);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element i of a chunk held as raw bits
template <bool XBF16>
__device__ __forceinline__ float elem(const uint4* v, int i) {
  if (XBF16) {
    const uint32_t w = word_of(v[0], i / 2);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  return __uint_as_float(word_of(v[i / 4], i % 4));
}

// The paths a ragged or unaligned call takes (K % 8 != 0, or x or the
// mask off 16/8-byte alignment) are out of line (__noinline__): the
// kernel's code stays small enough to stay in the instruction caches
// between launches of a decode step (PERF.md, PR 33).

// 4 elements of `size` bytes (2 or 4) from p, those at and past n 0, as
// the uint4 of their bits packed as a 16-byte load would give them
__device__ __noinline__ uint4 load_partial(const char* p, int size, int n) {
  uint32_t w[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16 / size && i < n; ++i) {
    const uint32_t b = size == 2 ? reinterpret_cast<const uint16_t*>(p)[i]
                                 : reinterpret_cast<const uint32_t*>(p)[i];
    w[i * size / 4] |= b << (8 * ((i * size) % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// up to 8 bytes from p, those at and past n 0
__device__ __noinline__ uint2 load_bytes(const uint8_t* p, int n) {
  uint32_t w[2] = {0, 0};
  for (int i = 0; i < 8 && i < n; ++i) w[i / 4] |= (uint32_t)p[i] << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

// n (< 8) bytes of the 8 in w to p
__device__ __noinline__ void store_partial(int8_t* p, uint2 w, int n) {
  for (int i = 0; i < n; ++i)
    p[i] = (int8_t)(((i < 4 ? w.x : w.y) >> (8 * (i % 4))) & 0xFF);
}

// x / s of a row whose scale lies outside the fast division's range
__device__ __noinline__ float divide_slow(float x, float s) {
  // 0 / s is 0 (of the sign of x, which rounding and the int cast drop);
  // a zero numerator sends __fdiv_rn down its slow path
  return x == 0.0f ? 0.0f : __fdiv_rn(x, s);
}

// The chunk of row `xrow` at column col (< K): 16-byte loads when `vec`
// (K % 8 == 0, x 16-byte aligned), else element by element, the columns
// past K 0.
template <bool XBF16>
__device__ __forceinline__ void load_chunk(const void* xrow, int col, int K,
                                           bool vec, uint4* v) {
  constexpr int CW = Width<XBF16>::CW, ESZ = XBF16 ? 2 : 4;
  const char* p = reinterpret_cast<const char*>(xrow) + (long)col * ESZ;
#pragma unroll
  for (int h = 0; h < CW; ++h)
    v[h] = vec ? __ldg(reinterpret_cast<const uint4*>(p) + h)
               : load_partial(p + 16 * h, ESZ, K - col - h * 16 / ESZ);
}

// the mask bytes of columns col..col+7 (< K), 0 past K
__device__ __forceinline__ uint2 load_mask(const uint8_t* col_mask, int col,
                                           int K, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint2*>(col_mask + col));
  return load_bytes(col_mask + col, K - col);
}

template <bool XBF16>
__device__ __forceinline__ float chunk_amax(const uint4* v, float am) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) am = fmaxf(am, fabsf(elem<XBF16>(v, i)));
  return am;
}

// Encode one chunk of 8 columns (row m, column col) held in v with mask
// bytes mk, store its planes where `store` (m < M, the chunk inside the
// plane), and return the chunk's PBM population. Every lane of the warp
// calls it (the packed word's shuffles); `store` is per lane.
template <int MODE, bool XBF16>
__device__ __forceinline__ int encode_chunk(
    const uint4* v, uint2 mk, const Divisor& d, bool masking, int clip_l,
    int clip_h,
    void* lsb, void* msb, void* pbm, long m, int col, int K, int KP,
    bool vec, bool store, int lane) {
  float f[CHUNK];
  if (d.fast) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) f[i] = divide_fast(elem<XBF16>(v, i), d);
  } else {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) f[i] = divide_slow(elem<XBF16>(v, i), d.s);
  }
  int q[CHUNK];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const uint32_t mb = ((i < 4 ? mk.x : mk.y) >> (8 * (i % 4))) & 0xFF;
    q[i] = round_clip(f[i], XBF16, masking && mb != 0, clip_l, clip_h);
  }
  // a plane's 8 bytes: 8-byte stores where whole and aligned, else the
  // bytes inside K
  auto put = [&](void* plane, uint2 w) {
    int8_t* at = reinterpret_cast<int8_t*>(plane) + m * K + col;
    if (vec) *reinterpret_cast<uint2*>(at) = w;
    else store_partial(at, w, min(K - col, CHUNK));
  };
  if (MODE == MODE_QUANTIZE) {
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      w[i / 4] |= (uint32_t)(uint8_t)q[i] << (8 * (i % 4));
    if (store) put(lsb, make_uint2(w[0], w[1]));
    return 0;
  }
  if (MODE == MODE_ENCODE) {
    uint32_t lw[2] = {0, 0}, hw[2] = {0, 0}, pw[2] = {0, 0};
    int local = 0;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int hi = q[i] >> 4;
      lw[i / 4] |= (uint32_t)(q[i] & 0xF) << (8 * (i % 4));
      hw[i / 4] |= (uint32_t)(uint8_t)hi << (8 * (i % 4));
      pw[i / 4] |= (uint32_t)(hi != 0) << (8 * (i % 4));
      local += (hi != 0);
    }
    if (store) {
      put(lsb, make_uint2(lw[0], lw[1]));
      put(msb, make_uint2(hw[0], hw[1]));
      if (pbm != nullptr) put(pbm, make_uint2(pw[0], pw[1]));
    }
    return local;
  }
  // MODE_PACKED
  uint32_t lo = 0, hi = 0, bits = 0;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const int h4 = q[i] >> 4;
    lo |= (uint32_t)(q[i] & 0xF) << (4 * i);
    hi |= (uint32_t)(h4 & 0xF) << (4 * i);
    bits |= (uint32_t)(h4 != 0) << i;
  }
  uint32_t word = bits << (8 * (lane & 3));
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  if (store) {
    const long at = m * (KP / 8) + col / 8;
    reinterpret_cast<uint32_t*>(lsb)[at] = lo;
    reinterpret_cast<uint32_t*>(msb)[at] = hi;
    if ((lane & 3) == 0)
      reinterpret_cast<uint32_t*>(pbm)[m * (KP / 32) + col / 32] = word;
  }
  return __popc(bits);
}

// grid (S, ceil(M / TILE_M), E), block R W 32 threads, with the scale
// computed here and S > 1 a cluster (S, 1, 1). MODE_ENCODE: lsb/msb int8
// (M, K), pbm uint8 or null, pop; MODE_QUANTIZE: q int8 (M, K) in lsb;
// MODE_PACKED: lsb/msb uint32 (M, KP/8), pbm uint32 (M, KP/32), pop.
// scale f32 (M): written (token_scale) by the cluster's block 0, or read
// when SCALE_IN (no amax). XBF16: x is bf16, else f32.
//
// Expert-batched (grid z = E > 1): x is (E, M, K) and every output has a
// leading E axis; expert e = blockIdx.z reads its own (M, K) slab, its
// own mask row col_mask[e] (an (E, K) mask) and writes its own scale
// rows, planes and (ceil(M / TILE_M), n_kt) populations, so no TILE_M
// tile straddles two experts. With E = 1 every offset is 0.
// `expert_rows` ((E,) int32, or null: all M): expert e's rows at and past
// expert_rows[e] read as 0 whatever x holds, so they encode as a zero
// row does (scale token_scale(0), planes and PBM 0, no population); a
// block whose row group lies wholly past it (and so its whole cluster)
// reads neither x nor the mask, writes those outputs and returns.
template <int MODE, bool XBF16, bool SCALE_IN>
__global__ void __launch_bounds__(MAX_THREADS, 2) sparqle_encode_kernel(
    const void* __restrict__ x, float* __restrict__ scale,
    const uint8_t* __restrict__ col_mask, int clip_l, int clip_h,
    void* __restrict__ lsb, void* __restrict__ msb, void* __restrict__ pbm,
    int32_t* __restrict__ pop, int M, int K, int KP,
    const int32_t* __restrict__ expert_rows, Plan plan) {
  constexpr int CW = Width<XBF16>::CW, JMAX = Width<XBF16>::JMAX;
  extern __shared__ __align__(16) unsigned char smem[];
  // the warps' amaxes (as bits): [warp] in the block, or in a cluster
  // [rank][warp] of every block's warps, landing on `pushed`
  __shared__ uint32_t part_amax[MAX_CLUSTER * MAX_THREADS / 32];
  __shared__ __align__(8) uint64_t pushed;
  const int W = plan.warps, J = plan.chunks, P = plan.passes;
  const int S = gridDim.x;
  const bool clustered = !SCALE_IN && S > 1;
  const int n_kt = (K + TILE_K - 1) / TILE_K;
  const int ML = expert_rows == nullptr
                     ? M : min(max(expert_rows[blockIdx.z], 0), M);
  {   // this expert's slabs
    const long e = blockIdx.z, rows = e * M;
    x = reinterpret_cast<const char*>(x) + rows * K * (XBF16 ? 2 : 4);
    scale += rows;
    if (col_mask != nullptr) col_mask += e * K;
    const long plane = MODE == MODE_PACKED ? rows * (KP / 2) : rows * K;
    lsb = reinterpret_cast<char*>(lsb) + plane;
    if (msb != nullptr) msb = reinterpret_cast<char*>(msb) + plane;
    if (pbm != nullptr)
      pbm = reinterpret_cast<char*>(pbm) +
            (MODE == MODE_PACKED ? rows * (KP / 8) : rows * K);
    if (pop != nullptr) pop += e * ((M + TILE_M - 1) / TILE_M) * n_kt;
  }
  const int t0 = blockIdx.x * plan.tiles, t1 = min(t0 + plan.tiles, n_kt);
  const int mt = blockIdx.y;
  if (mt * TILE_M >= ML) {
    // no live row in the group: a zero row's outputs (scale
    // token_scale(0), planes, PBM and populations 0), no x or mask read;
    // the whole cluster shares the group, so none of it waits
    const int m_lo = mt * TILE_M, m_n = min(TILE_M, M - m_lo);
    if (!SCALE_IN && blockIdx.x == 0 && threadIdx.x < m_n)
      scale[m_lo + threadIdx.x] = token_scale(0.0f, XBF16);
    const int c_lo = t0 * TILE_K;
    if (MODE == MODE_PACKED) {   // plane bytes and PBM words of the tiles
      const int c_hi = min(t1 * TILE_K, KP);
      const int nb = (c_hi - c_lo) / 2, nw = (c_hi - c_lo) / 32;
      for (int i = threadIdx.x; i < m_n * nb; i += blockDim.x) {
        const long at = (long)(m_lo + i / nb) * (KP / 2) + c_lo / 2 + i % nb;
        reinterpret_cast<int8_t*>(lsb)[at] = 0;
        reinterpret_cast<int8_t*>(msb)[at] = 0;
      }
      for (int i = threadIdx.x; i < m_n * nw; i += blockDim.x)
        reinterpret_cast<uint32_t*>(pbm)[(long)(m_lo + i / nw) * (KP / 32) +
                                         c_lo / 32 + i % nw] = 0u;
    } else {
      const int nc = min(t1 * TILE_K, K) - c_lo;
      for (int i = threadIdx.x; i < m_n * nc; i += blockDim.x) {
        const long at = (long)(m_lo + i / nc) * K + c_lo + i % nc;
        reinterpret_cast<int8_t*>(lsb)[at] = 0;
        if (MODE == MODE_ENCODE) {
          reinterpret_cast<int8_t*>(msb)[at] = 0;
          if (pbm != nullptr) reinterpret_cast<uint8_t*>(pbm)[at] = 0;
        }
      }
    }
    if (MODE != MODE_QUANTIZE)
      for (int tt = t0 + threadIdx.x; tt < t1; tt += blockDim.x)
        pop[(long)mt * n_kt + tt] = 0;
    return;
  }

  // the passes before the last, a chunk a thread each
  uint4* stage = reinterpret_cast<uint4*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / W, w = warp % W;
  const long m = (long)mt * TILE_M + r;
  const bool row = m < M, live = m < ML;   // warp-uniform
  const bool vec = (K % CHUNK) == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)col_mask & 7) == 0;
  const bool masking = col_mask != nullptr;
  const void* xrow = reinterpret_cast<const char*>(x) +
                     m * K * (XBF16 ? 2 : 4);
  const int c_lo = t0 * TILE_K;
  const int nch = (t1 - t0) * TILE_CHUNKS;   // the block's chunks a row
  // block-local chunk of (pass p, slot j)
  auto chunk_of = [&](int p, int j) {
    return ((p * J + j) * W + w) * 32 + lane;
  };

  // 1. x of this lane's chunks: the passes before the last into shared
  // memory, the last in registers with its mask bytes; the row's amax
  float am = 0.0f;
  float s = 1.0f;
  if (SCALE_IN && row) s = scale[m];
  for (int p = 0; p < P - 1; ++p) {
    uint4 v[JMAX * CW];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int c = chunk_of(p, j), col = c_lo + c * CHUNK;
#pragma unroll
      for (int h = 0; h < CW; ++h) v[j * CW + h] = make_uint4(0, 0, 0, 0);
      if (j < J && live && c < nch && col < K)
        load_chunk<XBF16>(xrow, col, K, vec, v + j * CW);
    }
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if (j >= J) continue;
      if (!SCALE_IN) am = chunk_amax<XBF16>(v + j * CW, am);
#pragma unroll
      for (int h = 0; h < CW; ++h)
        stage[((p * J + j) * blockDim.x + threadIdx.x) * CW + h] =
            v[j * CW + h];
    }
  }
  uint4 xr[JMAX * CW];
  uint2 mr[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int c = chunk_of(P - 1, j), col = c_lo + c * CHUNK;
#pragma unroll
    for (int h = 0; h < CW; ++h) xr[j * CW + h] = make_uint4(0, 0, 0, 0);
    mr[j] = make_uint2(0, 0);
    if (j < J && row && c < nch && col < K) {
      if (live) load_chunk<XBF16>(xrow, col, K, vec, xr + j * CW);
      if (masking) mr[j] = load_mask(col_mask, col, K, vec);
    }
  }

  // the block's tiles' populations start at 0 in device memory, and each
  // (row, tile)'s half warp adds its count; the barrier, while the loads
  // are in flight, puts the zeros before every add
  if (MODE != MODE_QUANTIZE) {
    for (int tt = t0 + threadIdx.x; tt < t1; tt += blockDim.x)
      pop[(long)mt * n_kt + tt] = 0;
    __syncthreads();
  }

  // 2. the scale: the warp's amax (a non-negative float: its bits order
  // as the value), then the row's W warps (through shared memory, one
  // block barrier) or, in a cluster, the row's W warps of all S blocks:
  // each warp's stored into every block by st.async, which counts its
  // bytes on that block's mbarrier `pushed`. The barrier is made ready
  // while the loads are in flight, and a block pushes only once every
  // block has arrived at the cluster barrier after making its own ready.
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&pushed);
  if (clustered) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(S * plan.rows * W * 4)
          : "memory");
    }
    // relaxed: a release here would wait for the loads in flight; the
    // barrier's initialisation is ordered by its own fence
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  if (!SCALE_IN) {
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
      if (j < J) am = chunk_amax<XBF16>(xr + j * CW, am);
    uint32_t a = __reduce_max_sync(0xffffffffu, __float_as_uint(am));
    if (clustered) {
      const int rank = (int)cg::this_cluster().block_rank();
      const int RW = plan.rows * W;
      // every block's barrier is ready
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      if (lane < S) {
        const unsigned slot =
            (unsigned)__cvta_generic_to_shared(&part_amax[rank * RW + warp]);
        unsigned to, to_bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(to) : "r"(slot), "r"(lane));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(to_bar) : "r"(bar), "r"(lane));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
            "[%0], %1, [%2];" ::"r"(to), "r"(a), "r"(to_bar)
            : "memory");
      }
      // every block's warps' amaxes have landed here; nothing remote is
      // read, and no block leaves before what is pushed to it lands
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar) : "memory");
      uint32_t b = 0;
      for (int i = lane; i < S * W; i += 32)
        b = max(b, part_amax[(i / W) * RW + r * W + i % W]);
      a = __reduce_max_sync(0xffffffffu, b);
    } else if (W > 1) {
      if (lane == 0) part_amax[warp] = a;
      __syncthreads();
      a = __reduce_max_sync(0xffffffffu,
                            lane < W ? part_amax[r * W + lane] : 0u);
    }
    s = token_scale(__uint_as_float(a), XBF16);
    if (blockIdx.x == 0 && w == 0 && lane == 0 && row) scale[m] = s;
  }
  const Divisor d = make_divisor(guard_scale(s));

  // 3. encode the chunks: the last pass from the registers it was loaded
  // into, then each staged pass loaded from shared memory into the same
  // registers (one copy of the loop's code); a tile's count summed over
  // its half warp and added to the tile's population
  if (row) {
    for (int k = 0; k < P; ++k) {
      const int p = k == 0 ? P - 1 : k - 1;
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        if (j >= J || k == 0) continue;
        const int c = chunk_of(p, j), col = c_lo + c * CHUNK;
#pragma unroll
        for (int h = 0; h < CW; ++h)
          xr[j * CW + h] =
              stage[((p * J + j) * blockDim.x + threadIdx.x) * CW + h];
        mr[j] = masking && c < nch && col < K
                    ? load_mask(col_mask, col, K, vec)
                    : make_uint2(0, 0);
      }
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        if (j >= J) continue;
        const int c = chunk_of(p, j), col = c_lo + c * CHUNK;
        const bool in = c < nch && col < (MODE == MODE_PACKED ? KP : K);
        int local = encode_chunk<MODE, XBF16>(
            xr + j * CW, mr[j], d, masking, clip_l, clip_h, lsb, msb, pbm,
            m, col, K, KP, vec, in, lane);
        if (MODE == MODE_QUANTIZE) continue;
        const int lo = __reduce_add_sync(0xffffffffu, lane < 16 ? local : 0);
        const int hi = __reduce_add_sync(0xffffffffu, lane < 16 ? 0 : local);
        local = lane < 16 ? lo : hi;
        if ((lane & 15) == 0 && c < nch && local)
          atomicAdd(&pop[(long)mt * n_kt + t0 + c / TILE_CHUNKS], local);
      }
    }
  }
}

template <int MODE, bool XBF16, bool SCALE_IN>
static int launch_as(const void* x, void* scale, const void* col_mask,
                     int clip_l, int clip_h, void* lsb, void* msb, void* pbm,
                     void* pop, int M, int K, int KP, int E, void* stream,
                     const void* rows, Plan p) {
  // the plan must cover the call: whole row groups, every chunk once,
  // a lane's registers, the block and the cluster the card takes
  const int n_kt = (K + TILE_K - 1) / TILE_K;
  const int threads = p.rows * p.warps * 32;
  if (p.rows < (M < TILE_M ? M : TILE_M) || p.rows > TILE_M || (p.rows & (p.rows - 1))
      || p.warps < 1 || threads > MAX_THREADS || p.tiles < 1
      || p.chunks < 1 || p.chunks > Width<XBF16>::JMAX || p.passes < 1
      || p.passes * p.chunks * p.warps * 32 < p.tiles * TILE_CHUNKS)
    return (int)cudaErrorInvalidValue;
  const int S = (n_kt + p.tiles - 1) / p.tiles;
  const bool clustered = !SCALE_IN && S > 1;
  if (clustered && S > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const size_t smem = plan_smem(p, XBF16);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = sparqle_encode_kernel<MODE, XBF16, SCALE_IN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (clustered && S > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (M + TILE_M - 1) / TILE_M, E);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clustered ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, x, (float*)scale, (const uint8_t*)col_mask, clip_l,
      clip_h, lsb, msb, pbm, (int32_t*)pop, M, K, KP, (const int32_t*)rows,
      p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MODE, bool SCALE_IN>
static int launch(const void* x, int x_bf16, const void* scale,
                  const void* col_mask, int clip_l, int clip_h, void* lsb,
                  void* msb, void* pbm, void* pop, int M, int K, int KP,
                  Plan p, void* stream, int E = 1,
                  const void* rows = nullptr) {
  void* s = const_cast<void*>(scale);
  return x_bf16 ? launch_as<MODE, true, SCALE_IN>(x, s, col_mask, clip_l,
                                                  clip_h, lsb, msb, pbm, pop,
                                                  M, K, KP, E, stream, rows,
                                                  p)
                : launch_as<MODE, false, SCALE_IN>(x, s, col_mask, clip_l,
                                                   clip_h, lsb, msb, pbm,
                                                   pop, M, K, KP, E, stream,
                                                   rows, p);
}

// Every entry takes the plan as its five ints (rows, tiles, warps,
// chunks, passes) after the shapes, then, batched, E and the live rows.
#define PLAN_ARGS int pr, int pt, int pw, int pj, int pp
#define PLAN Plan{pr, pt, pw, pj, pp}

// scale (M, 1) f32 in; lsb/msb int8 (M, K), pbm uint8 (M, K) or null,
// pop int32 (ceil(M/16), ceil(K/128)).
extern "C" int sparqle_encode_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, PLAN_ARGS, void* stream) {
  return launch<MODE_ENCODE, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, K, PLAN,
                                   stream);
}

// q (M, K) int8 only.
extern "C" int sparqle_quantize_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, PLAN_ARGS, void* stream) {
  return launch<MODE_QUANTIZE, true>(x, x_bf16, scale, col_mask, clip_l,
                                     clip_h, q, nullptr, nullptr, nullptr,
                                     M, K, K, PLAN, stream);
}

// KP = K padded to a multiple of 32; outputs (M, KP/2) x2, (M, KP/32)
// words and (ceil(M/16), ceil(K/128)) populations.
extern "C" int sparqle_encode_packed_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, PLAN_ARGS, void* stream) {
  return launch<MODE_PACKED, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, KP, PLAN,
                                   stream);
}

// scale (M, 1) f32 out; the rest as sparqle_encode_launch's.
extern "C" int sparqle_encode_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, PLAN_ARGS, void* stream) {
  return launch<MODE_ENCODE, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, K, PLAN,
                                    stream);
}

extern "C" int sparqle_quantize_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, PLAN_ARGS, void* stream) {
  return launch<MODE_QUANTIZE, false>(x, x_bf16, scale, col_mask, clip_l,
                                      clip_h, q, nullptr, nullptr, nullptr,
                                      M, K, K, PLAN, stream);
}

extern "C" int sparqle_encode_packed_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, PLAN_ARGS, void* stream) {
  return launch<MODE_PACKED, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, KP,
                                    PLAN, stream);
}

// The expert-batched forms of the three entries that take a scale: x
// (E, M, K), scale (E, M, 1), col_mask (E, K) or null, every output with
// a leading E axis; one launch encodes all E experts (grid z). The
// row-parallel routed projection under tensor parallelism calls them
// with its all-reduced scale. rows: (E,) int32 live rows an expert (the
// rest encode as zero rows), or null for all M.
extern "C" int sparqle_encode_batched_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, PLAN_ARGS, int E, const void* rows, void* stream) {
  return launch<MODE_ENCODE, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, K, PLAN,
                                   stream, E, rows);
}

extern "C" int sparqle_quantize_batched_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, PLAN_ARGS, int E,
    const void* rows, void* stream) {
  return launch<MODE_QUANTIZE, true>(x, x_bf16, scale, col_mask, clip_l,
                                     clip_h, q, nullptr, nullptr, nullptr,
                                     M, K, K, PLAN, stream, E, rows);
}

extern "C" int sparqle_encode_packed_batched_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, PLAN_ARGS, int E, const void* rows,
    void* stream) {
  return launch<MODE_PACKED, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, KP, PLAN,
                                   stream, E, rows);
}

// The expert-batched forms of the three fused entries: x (E, M, K),
// col_mask (E, K) or null, every output with a leading E axis, rows as
// above; one launch encodes all E experts (grid z).
extern "C" int sparqle_encode_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, PLAN_ARGS, int E, const void* rows, void* stream) {
  return launch<MODE_ENCODE, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, K, PLAN,
                                    stream, E, rows);
}

extern "C" int sparqle_quantize_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, PLAN_ARGS, int E,
    const void* rows, void* stream) {
  return launch<MODE_QUANTIZE, false>(x, x_bf16, scale, col_mask, clip_l,
                                      clip_h, q, nullptr, nullptr, nullptr,
                                      M, K, K, PLAN, stream, E, rows);
}

extern "C" int sparqle_encode_packed_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, PLAN_ARGS, int E, const void* rows,
    void* stream) {
  return launch<MODE_PACKED, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, KP,
                                    PLAN, stream, E, rows);
}

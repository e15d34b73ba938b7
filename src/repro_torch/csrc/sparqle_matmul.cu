// SPARQLe dual-pass W4A8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/sparqle_matmul.py`
// `sparqle_matmul` (`_kernel` -> `_tile_body` / `_drain`):
//   acc  = lsb4 @ w                          (dense LSB pass, every tile)
//   acc += (msb4 @ w) << 4                   (only where tile_pop > 0)
//   out  = float(acc) * act_scale * w_scale  (or the raw int32 acc)
// Unlike the Pallas kernel it takes the int4 weight PACKED two per byte
// along K (`qlinear.pack_int4`, (K/2, N) int8) and unpacks the nibbles
// in shared memory, so only K*N/2 weight bytes cross device memory.
//
// Bound: at decode (M <= 8) bytes — the packed weight stream dominates;
// at prefill (M = 32) still bytes on the H100's int8 rate. Design: an
// output-stationary int32 accumulator in registers, a loop over K tiles
// inside the block (the Pallas K grid axis), `__dp4a` s8 x s8 -> s32
// products. The K loop is split over gridDim.z so that narrow N (the
// 1024-wide K/V projections) still fills all 132 SMs; the split partial
// sums meet in an int32 buffer through atomicAdd, which is exact and
// order-free, and a second small kernel drains it. Ragged M/N/K edges
// load as zeros. No wgmma or TMA yet.
//
// The draft entry `sparqle_matmul_draft_launch` replaces the Pallas
// `_kernel_draft` (`sparqle_matmul(msb_skip=True)`): the same kernel
// instantiated with MSB_SKIP = true computes acc = lsb4 @ w alone. The
// MSB plane and the tile populations are not arguments of that entry at
// all, so it streams only the LSB plane and the weight (the Pallas
// draft grid likewise drops both operands); the drain is shared.
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 16      // rows per block == TILE_M of the PBM population
#define BN 64      // output columns per block
#define BK 128     // K per tile == TILE_K of the PBM population
#define THREADS 256
#define WPAD 4     // row pad of the unpacked weight tile: conflict-free reads

__device__ __forceinline__ void load_act_tile(
    const int8_t* __restrict__ a, int8_t (*dst)[BK], int m0, int k0,
    int M, int K) {
  const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 8;
  const int m = m0 + r, k = k0 + c;
  if (m < M && k + 8 <= K && (K % 8) == 0) {
    *reinterpret_cast<uint2*>(&dst[r][c]) =
        *reinterpret_cast<const uint2*>(a + (long)m * K + k);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[r][c + i] = (m < M && k + i < K) ? a[(long)m * K + k + i] : 0;
  }
}

// MSB_SKIP: the draft's LSB-only pass; msb and tile_pop are never read.
template <bool MSB_SKIP>
__global__ void sparqle_matmul_kernel(
    const int8_t* __restrict__ lsb, const int8_t* __restrict__ msb,
    const int32_t* __restrict__ tile_pop, const int8_t* __restrict__ wp,
    int32_t* __restrict__ acc_buf, int M, int N, int K, int tiles_per_split) {
  __shared__ __align__(16) int8_t w_s[BN][BK + WPAD];
  __shared__ __align__(16) int8_t a_l[BM][BK];
  __shared__ __align__(16) int8_t a_m[MSB_SKIP ? 1 : BM][BK];
  const int n0 = blockIdx.x * BN, mt = blockIdx.y, m0 = mt * BM;
  const int n_kt = (K + BK - 1) / BK;
  const int kt_lo = blockIdx.z * tiles_per_split;
  const int kt_hi = min(n_kt, kt_lo + tiles_per_split);
  const int K2 = K / 2;
  const int tn = threadIdx.x % BN, mg = threadIdx.x / BN;   // 64 x 4
  int acc_l[4] = {0, 0, 0, 0}, acc_m[4] = {0, 0, 0, 0};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    // uniform over the block; the draft has no MSB pass to gate
    const int pop = MSB_SKIP ? 0 : tile_pop[mt * n_kt + kt];
    // packed weight rows [kt*BK/2, +BK/2) x cols [n0, n0+BN): 16 B/thread
    {
      const int row = threadIdx.x / 4, cb = (threadIdx.x % 4) * 16;
      const int k2 = kt * (BK / 2) + row, n = n0 + cb;
      int8_t b[16];
      if (k2 < K2 && n + 16 <= N && (N % 16) == 0) {
        *reinterpret_cast<uint4*>(b) =
            *reinterpret_cast<const uint4*>(wp + (long)k2 * N + n);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          b[j] = (k2 < K2 && n + j < N) ? wp[(long)k2 * N + n + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int8_t v = b[j];
        // two's-complement nibbles: (x << 4) >> 4 and x >> 4 sign-extend
        w_s[cb + j][2 * row] = (int8_t)((int8_t)((uint8_t)v << 4) >> 4);
        w_s[cb + j][2 * row + 1] = (int8_t)(v >> 4);
      }
    }
    load_act_tile(lsb, a_l, m0, kt * BK, M, K);
    if (!MSB_SKIP && pop > 0) load_act_tile(msb, a_m, m0, kt * BK, M, K);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      const int wv = *reinterpret_cast<const int*>(&w_s[tn][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc_l[i] = __dp4a(*reinterpret_cast<const int*>(&a_l[mg * 4 + i][kk]),
                          wv, acc_l[i]);
    }
    if (!MSB_SKIP && pop > 0) {
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        const int wv = *reinterpret_cast<const int*>(&w_s[tn][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc_m[i] = __dp4a(
              *reinterpret_cast<const int*>(&a_m[mg * 4 + i][kk]), wv,
              acc_m[i]);
      }
    }
    __syncthreads();
  }
  const int n = n0 + tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mg * 4 + i;
    if (m < M && n < N) {
      const int part = acc_l[i] + acc_m[i] * 16;   // (msb @ w) << 4
      if (gridDim.z == 1) acc_buf[(long)m * N + n] = part;
      else atomicAdd(&acc_buf[(long)m * N + n], part);
    }
  }
}

__global__ void sparqle_drain_kernel(
    const int32_t* __restrict__ acc, const float* __restrict__ act_scale,
    const float* __restrict__ w_scale, float* __restrict__ out, int M,
    int N) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  // the reference's order: (f32(acc) * act_scale) * w_scale
  out[i] = __fmul_rn(__fmul_rn((float)acc[i], act_scale[m]), w_scale[n]);
}

template <bool MSB_SKIP>
static int launch(const void* lsb, const void* msb, const void* tile_pop,
                  const void* wp, const void* act_scale,
                  const void* w_scale, void* acc_buf, void* out, int M,
                  int N, int K, int splits, cudaStream_t s) {
  const int n_kt = (K + BK - 1) / BK;
  const int per = (n_kt + splits - 1) / splits;
  splits = (n_kt + per - 1) / per;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  sparqle_matmul_kernel<MSB_SKIP><<<grid, THREADS, 0, s>>>(
      (const int8_t*)lsb, (const int8_t*)msb, (const int32_t*)tile_pop,
      (const int8_t*)wp, (int32_t*)acc_buf, M, N, K, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return (int)err;
  const long total = (long)M * N;
  sparqle_drain_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const int32_t*)acc_buf, (const float*)act_scale,
      (const float*)w_scale, (float*)out, M, N);
  return (int)cudaGetLastError();
}

// acc_buf must be zero-filled when splits > 1; out == nullptr skips the
// drain (the caller wants the raw int32 accumulator).
extern "C" int sparqle_matmul_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* acc_buf, void* out,
    int M, int N, int K, int splits, void* stream) {
  return launch<false>(lsb, msb, tile_pop, wp, act_scale, w_scale, acc_buf,
                       out, M, N, K, splits, (cudaStream_t)stream);
}

// The LSB4-only draft: no MSB plane, no tile populations.
extern "C" int sparqle_matmul_draft_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* acc_buf, void* out, int M, int N, int K,
    int splits, void* stream) {
  return launch<true>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                      acc_buf, out, M, N, K, splits, (cudaStream_t)stream);
}

// The W4A8 tile machinery of the dense single-pass baseline
// (`quant_matmul.cu`): the tiling, the int4 weight unpack, the `__dp4a`
// pass over one K tile, the exact split-K store and the drain. (The
// dual-pass SPARQLe matmul, `sparqle_matmul.cu`, has its own tensor-core
// body and no longer includes this header.)
//
// A block owns BM rows x BN output columns and loops over its K tiles
// (BK each, the PBM population's TILE_K) inside the block; THREADS
// threads hold 4 rows x 1 column of int32 accumulator each. The weight
// arrives PACKED two int4 per byte along K (`qlinear.pack_int4`, (K/2, N)
// int8) and is unpacked into shared memory, so only K*N/2 weight bytes
// cross device memory. The K loop is split over gridDim.z so that narrow
// N still fills the card; split partial sums meet in an int32 buffer
// through atomicAdd, which is exact and order-free, and a second small
// kernel drains it. Ragged M/N/K edges load as zeros.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 16      // rows per block == TILE_M of the PBM population
#define BN 64      // output columns per block
#define BK 128     // K per tile == TILE_K of the PBM population
#define THREADS 256
#define WPAD 4     // row pad of the unpacked weight tile: conflict-free reads

typedef int8_t weight_tile[BN][BK + WPAD];
typedef int8_t act_tile[BM][BK];

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

// packed weight rows [kt*BK/2, +BK/2) x cols [n0, n0+BN), 16 B/thread,
// unpacked to w_s[column][k]
__device__ __forceinline__ void load_weight_tile(
    const int8_t* __restrict__ wp, int8_t (*w_s)[BK + WPAD], int kt, int n0,
    int N, int K2) {
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

// acc[i] += a[mg*4 + i][:] . w[tn][:] over one K tile, s8 x s8 -> s32
__device__ __forceinline__ void dp4a_tile(const int8_t (*w_s)[BK + WPAD],
                                          const int8_t (*a)[BK], int tn,
                                          int mg, int acc[4]) {
#pragma unroll 4
  for (int kk = 0; kk < BK; kk += 4) {
    const int wv = *reinterpret_cast<const int*>(&w_s[tn][kk]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = __dp4a(*reinterpret_cast<const int*>(&a[mg * 4 + i][kk]), wv,
                      acc[i]);
  }
}

// this thread's 4 x 1 accumulator into acc_buf (atomically when split)
__device__ __forceinline__ void store_acc(int32_t* __restrict__ acc_buf,
                                          const int part[4], int m0, int mg,
                                          int n, int M, int N) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mg * 4 + i;
    if (m < M && n < N) {
      if (gridDim.z == 1) acc_buf[(long)m * N + n] = part[i];
      else atomicAdd(&acc_buf[(long)m * N + n], part[i]);
    }
  }
}

__global__ void w4a8_drain_kernel(
    const int32_t* __restrict__ acc, const float* __restrict__ act_scale,
    const float* __restrict__ w_scale, float* __restrict__ out, int M,
    int N) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  // the reference's order: (f32(acc) * act_scale) * w_scale
  out[i] = __fmul_rn(__fmul_rn((float)acc[i], act_scale[m]), w_scale[n]);
}

// grid of a split-K launch and the K tiles each split walks
static inline dim3 w4a8_grid(int M, int N, int K, int splits, int* per) {
  const int n_kt = (K + BK - 1) / BK;
  *per = (n_kt + splits - 1) / splits;
  splits = (n_kt + *per - 1) / *per;
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
}

// after the matmul kernel: the drain, unless out is null (raw int32 acc)
static inline int w4a8_drain(const void* acc_buf, const void* act_scale,
                             const void* w_scale, void* out, int M, int N,
                             cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return (int)err;
  const long total = (long)M * N;
  w4a8_drain_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const int32_t*)acc_buf, (const float*)act_scale,
      (const float*)w_scale, (float*)out, M, N);
  return (int)cudaGetLastError();
}

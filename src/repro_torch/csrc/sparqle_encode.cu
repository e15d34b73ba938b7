// Fused SPARQLe drain encoder for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/sparqle_encode.py`
// `sparqle_encode` (`_kernel`, `_quantize`). Per element of x (M, K):
//   q = clamp(rint(x / scale_row), -128, 127)  (quotient rounded to bf16
//       first when x is bf16, as the serving path forms it in x's dtype)
//   optional serve-time clip on masked columns: [l, 0) -> 0, (15, h] -> 15
//   lsb = q & 0xF, msb = q >> 4, pbm = msb != 0 (not stored when pbm
//   is null: the serving linear reads only the tile populations)
// and the PBM population of each (TILE_M, TILE_K) tile, which the
// dual-pass matmul reads to skip its MSB pass.
//
// Bound: bytes. It reads x once (2 or 4 B/elem) and writes 2-3 B/elem
// plus one int32 per tile; the arithmetic is a handful of ops/elem.
// Design: one block per (TILE_M x TILE_K) tile, so the tile's
// population is a block reduction in shared memory with no atomics to
// device memory; each thread handles 8 consecutive elements of one row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TILE_M 16
#define TILE_K 128
#define THREADS 256
#define PER_THREAD (TILE_M * TILE_K / THREADS)   // 8

__device__ __forceinline__ float load_x(const void* x, long idx, int bf16) {
  if (bf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[idx]);
  }
  return reinterpret_cast<const float*>(x)[idx];
}

__global__ void sparqle_encode_kernel(
    const void* __restrict__ x, int x_bf16, const float* __restrict__ scale,
    const uint8_t* __restrict__ col_mask, int clip_l, int clip_h,
    int8_t* __restrict__ lsb, int8_t* __restrict__ msb,
    uint8_t* __restrict__ pbm, int32_t* __restrict__ pop, int M, int K) {
  const int kt = blockIdx.x, mt = blockIdx.y;
  const int r = threadIdx.x / (TILE_K / PER_THREAD);         // 0..15
  const int c0 = (threadIdx.x % (TILE_K / PER_THREAD)) * PER_THREAD;
  const int m = mt * TILE_M + r;
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  int local = 0;
  if (m < M) {
    float s = scale[m];
    if (fabsf(s) < 1.17549435e-38f) s = 1.0f;   // f32 tiny: degenerate row
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int k = kt * TILE_K + c0 + i;
      if (k >= K) break;
      const long idx = (long)m * K + k;
      float v = __fdiv_rn(load_x(x, idx, x_bf16), s);
      if (x_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      v = fminf(fmaxf(rintf(v), -128.0f), 127.0f);
      int q = (int)v;
      if (col_mask != nullptr && col_mask[k]) {
        if (q >= clip_l && q < 0) q = 0;
        else if (q > 15 && q <= clip_h) q = 15;
      }
      const int hi = q >> 4;        // arithmetic shift: sign-extends
      lsb[idx] = (int8_t)(q & 0xF);
      msb[idx] = (int8_t)hi;
      if (pbm != nullptr) pbm[idx] = (uint8_t)(hi != 0);
      local += (hi != 0);
    }
  }
  // warp reduce, then one shared atomic per warp
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) pop[mt * gridDim.x + kt] = count;
}

extern "C" int sparqle_encode_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, void* stream) {
  dim3 grid((K + TILE_K - 1) / TILE_K, (M + TILE_M - 1) / TILE_M);
  sparqle_encode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, x_bf16, (const float*)scale, (const uint8_t*)col_mask, clip_l,
      clip_h, (int8_t*)lsb, (int8_t*)msb, (uint8_t*)pbm, (int32_t*)pop, M, K);
  return (int)cudaGetLastError();
}

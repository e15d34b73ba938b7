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
//
// The quantize-only entry `sparqle_quantize_launch` is the `_quantize`
// step of the same Pallas kernel without the split: it writes the
// clipped int8 activation q (one plane, no populations), which the
// dense W4A8 baseline's single-pass matmul reads. Both kernels call one
// per-element device function, so its q equals 16 * msb + lsb of the
// full encoder bit for bit. Bound: bytes (x read once, 1 B/elem out);
// one thread per 8 consecutive elements of a row.
//
// The packed entry `sparqle_encode_packed_launch` replaces the Pallas
// `sparqle_encode_packed` (`_kernel_packed`): the same per-element
// quantize and clip, emitted in the wire layout of `core/packing.py`
// with K padded to KP = a multiple of 32 (padded columns encode as 0,
// PBM 0): LSB4 and MSB4 packed two per byte (M, KP/2) -- byte j holds
// column 2j low and 2j+1 high -- and the PBM in 32-bit words (M, KP/32),
// bit i of word w = column 32w + i, plus the tile populations. The
// tiling is the full encoder's, so a thread's 8 columns are 4 bytes of
// each plane (one 32-bit store each) and one byte of a PBM word; the 4
// lanes that share a word OR their bytes together with two shuffles.
// Bound: bytes, 1.125 B/elem out instead of 2 (3 with the PBM plane).
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

// round(x / s) clipped to int8, then the serve-time clip on a masked
// column: [l, 0) -> 0, (15, h] -> 15.
__device__ __forceinline__ int quantize_clip(float xv, float s, int x_bf16,
                                             bool masked, int clip_l,
                                             int clip_h) {
  float v = __fdiv_rn(xv, s);
  if (x_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  v = fminf(fmaxf(rintf(v), -128.0f), 127.0f);
  int q = (int)v;
  if (masked) {
    if (q >= clip_l && q < 0) q = 0;
    else if (q > 15 && q <= clip_h) q = 15;
  }
  return q;
}

__device__ __forceinline__ float row_scale(const float* scale, int m) {
  const float s = scale[m];
  return fabsf(s) < 1.17549435e-38f ? 1.0f : s;   // f32 tiny: degenerate
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
    const float s = row_scale(scale, m);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int k = kt * TILE_K + c0 + i;
      if (k >= K) break;
      const long idx = (long)m * K + k;
      const int q = quantize_clip(load_x(x, idx, x_bf16), s, x_bf16,
                                  col_mask != nullptr && col_mask[k],
                                  clip_l, clip_h);
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

// q (M, K) int8 only; grid (ceil(K / (PER_THREAD * THREADS)), M).
__global__ void sparqle_quantize_kernel(
    const void* __restrict__ x, int x_bf16, const float* __restrict__ scale,
    const uint8_t* __restrict__ col_mask, int clip_l, int clip_h,
    int8_t* __restrict__ q, int K) {
  const int m = blockIdx.y;
  const int k0 = (blockIdx.x * THREADS + threadIdx.x) * PER_THREAD;
  const float s = row_scale(scale, m);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int k = k0 + i;
    if (k >= K) break;
    const long idx = (long)m * K + k;
    q[idx] = (int8_t)quantize_clip(load_x(x, idx, x_bf16), s, x_bf16,
                                   col_mask != nullptr && col_mask[k],
                                   clip_l, clip_h);
  }
}

// grid (ceil(KP / TILE_K), ceil(M / TILE_M)); lsb/msb as 32-bit words
// of 8 packed nibbles, (M, KP/8) each, pbm (M, KP/32).
__global__ void sparqle_encode_packed_kernel(
    const void* __restrict__ x, int x_bf16, const float* __restrict__ scale,
    const uint8_t* __restrict__ col_mask, int clip_l, int clip_h,
    uint32_t* __restrict__ lsb, uint32_t* __restrict__ msb,
    uint32_t* __restrict__ pbm, int32_t* __restrict__ pop, int M, int K,
    int KP) {
  const int kt = blockIdx.x, mt = blockIdx.y;
  const int r = threadIdx.x / (TILE_K / PER_THREAD);         // 0..15
  const int c0 = (threadIdx.x % (TILE_K / PER_THREAD)) * PER_THREAD;
  const int m = mt * TILE_M + r, k0 = kt * TILE_K + c0;
  const int lane = threadIdx.x & 31;
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  uint32_t lo = 0, hi = 0, bits = 0;
  if (m < M) {
    const float s = row_scale(scale, m);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int k = k0 + i;
      if (k >= K) break;                 // padded columns stay 0
      const int q = quantize_clip(load_x(x, (long)m * K + k, x_bf16), s,
                                  x_bf16, col_mask != nullptr && col_mask[k],
                                  clip_l, clip_h);
      const int h4 = q >> 4;             // arithmetic shift: sign-extends
      lo |= (uint32_t)(q & 0xF) << (4 * i);
      hi |= (uint32_t)(h4 & 0xF) << (4 * i);
      bits |= (uint32_t)(h4 != 0) << i;
    }
  }
  // lanes 4j..4j+3 hold columns [32w, 32w + 32) of one row: OR their
  // bytes into the word (every lane of the warp takes part)
  uint32_t word = bits << (8 * (lane & 3));
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  // KP is a multiple of 32 and k0 of 8: a thread's 8 columns lie all
  // inside the padded row or all past it
  if (m < M && k0 < KP) {
    const long at = (long)m * (KP / 8) + k0 / 8;
    lsb[at] = lo;
    msb[at] = hi;
    if ((lane & 3) == 0) pbm[(long)m * (KP / 32) + k0 / 32] = word;
  }
  int local = __popc(bits);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0 && local) atomicAdd(&count, local);
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

extern "C" int sparqle_quantize_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, void* stream) {
  const int per_block = PER_THREAD * THREADS;
  dim3 grid((K + per_block - 1) / per_block, M);
  sparqle_quantize_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, x_bf16, (const float*)scale, (const uint8_t*)col_mask, clip_l,
      clip_h, (int8_t*)q, K);
  return (int)cudaGetLastError();
}

// KP = K padded to a multiple of 32; outputs (M, KP/2) x2, (M, KP/32)
// words and (ceil(M/16), ceil(K/128)) populations.
extern "C" int sparqle_encode_packed_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, void* stream) {
  dim3 grid((KP + TILE_K - 1) / TILE_K, (M + TILE_M - 1) / TILE_M);
  sparqle_encode_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, x_bf16, (const float*)scale, (const uint8_t*)col_mask, clip_l,
      clip_h, (uint32_t*)lsb, (uint32_t*)msb, (uint32_t*)pbm, (int32_t*)pop,
      M, K, KP);
  return (int)cudaGetLastError();
}

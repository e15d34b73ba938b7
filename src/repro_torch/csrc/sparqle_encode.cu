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
//     w = column 32w + i; a thread's 8 columns are 4 bytes of each plane
//     (one 32-bit store each) and one byte of a PBM word, and the 4
//     lanes that share a word OR their bytes with two shuffles.
// Bound: bytes. x is read once from device memory (2 or 4 B/elem; the
// amax pass re-reads it from L2), 2-3 B/elem out (1 for q, 1.125 packed)
// plus one int32 a tile.
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
// passes one formed from an all-reduced amax. The row amax has to be
// complete before any tile quantizes. `fused_plan` gives each TILE_M-row
// group at most MAX_BLOCKS blocks of `tiles` consecutive TILE_K tiles, a
// pure function of K (with SCALE_IN, blocks of at most SCALE_IN_TILES).
// Every block reads its rows over all of K (from L2, 64 threads a row)
// for the amax while its own slice of x and of the mask lands in shared
// memory by cp.async, forms the scale, then encodes its tiles, 4 at a
// time, from shared memory; each block counts its own tiles'
// populations, no atomics to device memory. Spreading the amax over
// all 32 warps (4 a row at M = 8) was 9% slower on an H100 (`PERF.md`,
// PR 16). A thread-block
// cluster that shared the partial amax through distributed shared memory
// instead read each row once but waited on a cluster barrier: 6.4 us
// against 5.3 at M = 8, K = 4096, bf16, equal at K = 14336, on an H100
// (`PERF.md`, PR 16), so the blocks re-read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TILE_M 16
#define TILE_K 128
#define THREADS 256
#define PER_THREAD (TILE_M * TILE_K / THREADS)   // 8
#define MAX_BLOCKS 8   // blocks a row group
#define SCALE_IN_TILES 4   // most tiles a block when the scale is an input

__device__ __forceinline__ float load_x(const void* x, long idx, int bf16) {
  if (bf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[idx]);
  }
  return reinterpret_cast<const float*>(x)[idx];
}

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

__device__ __forceinline__ int quantize_clip(float xv, float s, int x_bf16,
                                             bool masked, int clip_l,
                                             int clip_h) {
  // 0 / s is 0 (of the sign of x, which rounding and the int cast drop);
  // a zero numerator sends __fdiv_rn down its slow path
  const float v = xv == 0.0f ? 0.0f : __fdiv_rn(xv, s);
  return round_clip(v, x_bf16, masked, clip_l, clip_h);
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

// ---------------------------------------------------------------------------
// up to MAX_BLOCKS blocks a TILE_M-row group
// ---------------------------------------------------------------------------

#define MODE_ENCODE 0
#define MODE_QUANTIZE 1
#define MODE_PACKED 2

struct FusedPlan {
  int blocks, tiles;    // blocks a row group, TILE_K tiles a block
};

// With the scale an input no block needs its rows' amax, so a block
// holds at most SCALE_IN_TILES tiles (any K fits the default 48 KB);
// which block counts a tile changes no output.
__host__ __device__ inline FusedPlan fused_plan(int n_kt, bool scale_in) {
  int tiles = (n_kt + MAX_BLOCKS - 1) / MAX_BLOCKS;
  if (scale_in && tiles > SCALE_IN_TILES) tiles = SCALE_IN_TILES;
  return {(n_kt + tiles - 1) / tiles, tiles};
}

// Dynamic shared memory: `tiles` int population counts, the column
// mask's slice (tiles * TILE_K bytes), then the x slice, TILE_M rows of
// tiles * TILE_K elements in x's dtype; each part 16-byte aligned.
__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t fused_smem(int tiles, int x_bf16) {
  return (size_t)align16(tiles * 4) + (size_t)align16(tiles * TILE_K) +
         (size_t)TILE_M * tiles * TILE_K * (x_bf16 ? 2 : 4);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}

// Threads of a block: SUB_TILES tiles at a time, THREADS a tile (row r,
// 8 columns from c0).
#define SUB_TILES 4
#define FUSED_THREADS (THREADS * SUB_TILES)

// grid (blocks, ceil(M / TILE_M)); MODE_ENCODE: lsb/msb int8 (M, K), pbm
// uint8 or null, pop; MODE_QUANTIZE: q int8 (M, K) in lsb; MODE_PACKED:
// lsb/msb uint32 (M, KP/8), pbm uint32 (M, KP/32), pop. scale f32 (M):
// written (token_scale), or read when SCALE_IN (no amax pass). XBF16: x
// is bf16, else f32.
//
// Latency, not bytes, bounds a block: its slice arrives by cp.async (all
// tiles' copies in flight at once, 16 bytes of x and 8 of the mask a
// thread and tile) when K is a multiple of 8 and x is 16-byte aligned,
// else element by element; SUB_TILES tiles are encoded at once, each
// thread's 8 elements without branches, warps of rows past M idle;
// planes leave as 8-byte stores where aligned.
//
// Expert-batched (grid z = E > 1): x is (E, M, K) and every output has a
// leading E axis; expert e = blockIdx.z reads its own (M, K) slab, its
// own mask row col_mask[e] (an (E, K) mask) and writes its own scale
// rows, planes and (ceil(M / TILE_M), n_kt) populations, so no TILE_M
// tile straddles two experts. With E = 1 every offset is 0.
// `expert_rows` ((E,) int32, or null: all M): expert e's rows at and past
// expert_rows[e] read as 0 whatever x holds, so they encode as a zero
// row does (scale token_scale(0), planes and PBM 0, no population); a
// block whose row group lies wholly past it reads neither x nor the
// mask, writes those outputs and returns before the amax pass.
template <int MODE, bool XBF16, bool SCALE_IN>
__global__ void __launch_bounds__(FUSED_THREADS) sparqle_encode_kernel(
    const void* __restrict__ x, float* __restrict__ scale,
    const uint8_t* __restrict__ col_mask, int clip_l, int clip_h,
    void* __restrict__ lsb, void* __restrict__ msb, void* __restrict__ pbm,
    int32_t* __restrict__ pop, int M, int K, int KP,
    const int32_t* __restrict__ expert_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float amax_w[FUSED_THREADS / 32], scale_s[TILE_M];
  const int x_bf16 = XBF16;
  const int n_kt = (K + TILE_K - 1) / TILE_K;
  // rows of x read (the rest read as 0)
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
  const FusedPlan fp = fused_plan(n_kt, SCALE_IN);
  const int t0 = blockIdx.x * fp.tiles, t1 = min(t0 + fp.tiles, n_kt);
  const int W = fp.tiles * TILE_K;                   // smem row, elements
  int* count = reinterpret_cast<int*>(smem);
  uint8_t* mask_s = smem + align16(fp.tiles * 4);
  unsigned char* xs = mask_s + align16(fp.tiles * TILE_K);
  const int esz = XBF16 ? 2 : 4;
  const int mt = blockIdx.y;
  const int sub = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int r = tid / (TILE_K / PER_THREAD);                  // 0..15
  const int c0 = (tid % (TILE_K / PER_THREAD)) * PER_THREAD;
  const int m = mt * TILE_M + r;
  const int lane = threadIdx.x & 31;
  // a warp covers rows 2w, 2w + 1 of its sub-tile: past M it idles
  const bool warp_rows = mt * TILE_M + (tid / 32) * 2 < M;
  if (mt * TILE_M >= ML) {
    // no live row in the group: a zero row's outputs (scale
    // token_scale(0), planes, PBM and populations 0), no x or mask read
    const int m_lo = mt * TILE_M, m_n = min(TILE_M, M - m_lo);
    if (!SCALE_IN && blockIdx.x == 0 && threadIdx.x < m_n)
      scale[m_lo + threadIdx.x] = token_scale(0.0f, x_bf16);
    const int c_lo = t0 * TILE_K;
    if (MODE == MODE_PACKED) {   // plane bytes and PBM words of the tiles
      const int c_hi = min(t1 * TILE_K, KP);
      const int nb = (c_hi - c_lo) / 2, nw = (c_hi - c_lo) / 32;
      for (int i = threadIdx.x; i < m_n * nb; i += FUSED_THREADS) {
        const long at = (long)(m_lo + i / nb) * (KP / 2) + c_lo / 2 + i % nb;
        reinterpret_cast<int8_t*>(lsb)[at] = 0;
        reinterpret_cast<int8_t*>(msb)[at] = 0;
      }
      for (int i = threadIdx.x; i < m_n * nw; i += FUSED_THREADS)
        reinterpret_cast<uint32_t*>(pbm)[(long)(m_lo + i / nw) * (KP / 32) +
                                         c_lo / 32 + i % nw] = 0u;
    } else {
      const int nc = min(t1 * TILE_K, K) - c_lo;
      for (int i = threadIdx.x; i < m_n * nc; i += FUSED_THREADS) {
        const long at = (long)(m_lo + i / nc) * K + c_lo + i % nc;
        reinterpret_cast<int8_t*>(lsb)[at] = 0;
        if (MODE == MODE_ENCODE) {
          reinterpret_cast<int8_t*>(msb)[at] = 0;
          if (pbm != nullptr) reinterpret_cast<uint8_t*>(pbm)[at] = 0;
        }
      }
    }
    if (MODE != MODE_QUANTIZE)
      for (int tt = t0 + threadIdx.x; tt < t1; tt += FUSED_THREADS)
        pop[(long)mt * n_kt + tt] = 0;
    return;
  }
  for (int i = threadIdx.x; i < fp.tiles; i += FUSED_THREADS) count[i] = 0;

  // 1. this block's slice of x (and of the mask) into shared memory
  const bool vec = (K % PER_THREAD) == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)col_mask & 7) == 0;
  for (int tt = t0 + sub; tt < t1; tt += SUB_TILES) {
    const int k0 = tt * TILE_K + c0, lc = (tt - t0) * TILE_K + c0;
    if (vec) {
      if (k0 >= K) continue;                         // K % 8 == 0: whole
      if (m < ML) {
        const char* src = reinterpret_cast<const char*>(x) +
                          ((long)m * K + k0) * esz;
        unsigned char* dst = xs + ((long)r * W + lc) * esz;
        for (int h = 0; h < PER_THREAD * esz; h += 16)
          cp_async(dst + h, src + h, 16);
      }
      if (r == 0 && col_mask != nullptr)
        cp_async(mask_s + lc, col_mask + k0, 8);
    } else {
      for (int i = 0; i < PER_THREAD && k0 + i < K; ++i) {
        if (m < ML) {
          const long g = (long)m * K + k0 + i, at = (long)r * W + lc + i;
          if (x_bf16)
            reinterpret_cast<__nv_bfloat16*>(xs)[at] =
                reinterpret_cast<const __nv_bfloat16*>(x)[g];
          else
            reinterpret_cast<float*>(xs)[at] =
                reinterpret_cast<const float*>(x)[g];
        }
        if (r == 0 && col_mask != nullptr) mask_s[lc + i] = col_mask[k0 + i];
      }
    }
  }
  // 2. the rows' amax over all of K, from device memory (L2), while the
  // copies land: 64 threads a row, two warps
  if (!SCALE_IN) {
    const int rr = threadIdx.x >> 6, j = threadIdx.x & 63;
    const int mrow = mt * TILE_M + rr;
    float am = 0.0f;
    if (mrow < ML) {
      if (vec) {
#pragma unroll 4
        for (int k = j * PER_THREAD; k < K; k += 64 * PER_THREAD) {
          if (XBF16) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                reinterpret_cast<const __nv_bfloat16*>(x) + (long)mrow * K +
                k));
            const __nv_bfloat16* e =
                reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i)
              am = fmaxf(am, fabsf(__bfloat162float(e[i])));
          } else {
            const float4* p4 = reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(x) + (long)mrow * K + k);
            const float4 v0 = __ldg(p4), v1 = __ldg(p4 + 1);
            am = fmaxf(am, fmaxf(fmaxf(fabsf(v0.x), fabsf(v0.y)),
                                 fmaxf(fabsf(v0.z), fabsf(v0.w))));
            am = fmaxf(am, fmaxf(fmaxf(fabsf(v1.x), fabsf(v1.y)),
                                 fmaxf(fabsf(v1.z), fabsf(v1.w))));
          }
        }
      } else {
        for (int k = j; k < K; k += 64)
          am = fmaxf(am, fabsf(load_x(x, (long)mrow * K + k, x_bf16)));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
    if (lane == 0) amax_w[threadIdx.x >> 5] = am;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();   // amax partials; the mask row is shared by the rows
  if (threadIdx.x < TILE_M) {
    const int mm = mt * TILE_M + threadIdx.x;
    if (SCALE_IN) {
      scale_s[threadIdx.x] = mm < M ? scale[mm] : 1.0f;
    } else {
      const float s = token_scale(
          fmaxf(amax_w[2 * threadIdx.x], amax_w[2 * threadIdx.x + 1]),
          x_bf16);
      scale_s[threadIdx.x] = s;
      if (blockIdx.x == 0 && mm < M) scale[mm] = s;
    }
  }
  __syncthreads();
  // x at local column lc of this thread's row; 0 outside the row or K
  auto xval = [&](int lc, bool ok) {
    const long at = (long)r * W + lc;
    const float v =
        XBF16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(xs)[at])
              : reinterpret_cast<const float*>(xs)[at];
    return ok ? v : 0.0f;
  };
  // 3. encode the block's tiles from shared memory
  const float s = guard_scale(scale_s[r]);
  for (int tt = t0 + sub; warp_rows && tt < t1; tt += SUB_TILES) {
    const int k0 = tt * TILE_K + c0, lc = (tt - t0) * TILE_K + c0;
    int q[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const bool ok = m < ML && k0 + i < K;
      q[i] = quantize_clip(xval(lc + i, ok), s, x_bf16,
                           ok && col_mask != nullptr && mask_s[lc + i],
                           clip_l, clip_h);
    }
    if (MODE == MODE_QUANTIZE) {
      int8_t* qo = reinterpret_cast<int8_t*>(lsb) + (long)m * K + k0;
      if (vec && m < M && k0 < K) {
        uint32_t w[2] = {0, 0};
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i)
          w[i / 4] |= (uint32_t)(uint8_t)q[i] << (8 * (i % 4));
        *reinterpret_cast<uint2*>(qo) = make_uint2(w[0], w[1]);
      } else {
        for (int i = 0; i < PER_THREAD; ++i)
          if (m < M && k0 + i < K) qo[i] = (int8_t)q[i];
      }
      continue;
    }
    int local = 0;
    if (MODE == MODE_ENCODE) {
      uint32_t lw[2] = {0, 0}, hw[2] = {0, 0}, pw[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int hi = q[i] >> 4;
        lw[i / 4] |= (uint32_t)(q[i] & 0xF) << (8 * (i % 4));
        hw[i / 4] |= (uint32_t)(uint8_t)hi << (8 * (i % 4));
        pw[i / 4] |= (uint32_t)(hi != 0) << (8 * (i % 4));
        local += (hi != 0);
      }
      const long idx = (long)m * K + k0;
      if (vec && m < M && k0 < K) {
        *reinterpret_cast<uint2*>(reinterpret_cast<int8_t*>(lsb) + idx) =
            make_uint2(lw[0], lw[1]);
        *reinterpret_cast<uint2*>(reinterpret_cast<int8_t*>(msb) + idx) =
            make_uint2(hw[0], hw[1]);
        if (pbm != nullptr)
          *reinterpret_cast<uint2*>(reinterpret_cast<uint8_t*>(pbm) + idx) =
              make_uint2(pw[0], pw[1]);
      } else {
        for (int i = 0; i < PER_THREAD; ++i) {
          if (m < M && k0 + i < K) {
            const int hi = q[i] >> 4;
            reinterpret_cast<int8_t*>(lsb)[idx + i] = (int8_t)(q[i] & 0xF);
            reinterpret_cast<int8_t*>(msb)[idx + i] = (int8_t)hi;
            if (pbm != nullptr)
              reinterpret_cast<uint8_t*>(pbm)[idx + i] = (uint8_t)(hi != 0);
          }
        }
      }
    } else {                                   // MODE_PACKED
      uint32_t lo = 0, hi = 0, bits = 0;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int h4 = q[i] >> 4;
        lo |= (uint32_t)(q[i] & 0xF) << (4 * i);
        hi |= (uint32_t)(h4 & 0xF) << (4 * i);
        bits |= (uint32_t)(h4 != 0) << i;
      }
      uint32_t word = bits << (8 * (lane & 3));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      if (m < M && k0 < KP) {
        const long at = (long)m * (KP / 8) + k0 / 8;
        reinterpret_cast<uint32_t*>(lsb)[at] = lo;
        reinterpret_cast<uint32_t*>(msb)[at] = hi;
        if ((lane & 3) == 0)
          reinterpret_cast<uint32_t*>(pbm)[(long)m * (KP / 32) + k0 / 32] =
              word;
      }
      local = __popc(bits);
    }
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0 && local) atomicAdd(&count[tt - t0], local);
  }
  if (MODE != MODE_QUANTIZE) {
    __syncthreads();
    for (int tt = t0 + threadIdx.x; tt < t1; tt += FUSED_THREADS)
      pop[(long)mt * n_kt + tt] = count[tt - t0];
  }
}

template <int MODE, bool XBF16, bool SCALE_IN>
static int launch_as(const void* x, void* scale, const void* col_mask,
                     int clip_l, int clip_h, void* lsb, void* msb, void* pbm,
                     void* pop, int M, int K, int KP, int E, void* stream,
                     const void* rows) {
  const FusedPlan fp = fused_plan((K + TILE_K - 1) / TILE_K, SCALE_IN);
  const size_t smem = fused_smem(fp.tiles, XBF16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sparqle_encode_kernel<MODE, XBF16, SCALE_IN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(fp.blocks, (M + TILE_M - 1) / TILE_M, E);
  sparqle_encode_kernel<MODE, XBF16, SCALE_IN>
      <<<grid, FUSED_THREADS, smem, (cudaStream_t)stream>>>(
          x, (float*)scale, (const uint8_t*)col_mask, clip_l, clip_h, lsb,
          msb, pbm, (int32_t*)pop, M, K, KP, (const int32_t*)rows);
  return (int)cudaGetLastError();
}

template <int MODE, bool SCALE_IN>
static int launch(const void* x, int x_bf16, const void* scale,
                  const void* col_mask, int clip_l, int clip_h, void* lsb,
                  void* msb, void* pbm, void* pop, int M, int K, int KP,
                  void* stream, int E = 1, const void* rows = nullptr) {
  void* s = const_cast<void*>(scale);
  return x_bf16 ? launch_as<MODE, true, SCALE_IN>(x, s, col_mask, clip_l,
                                                  clip_h, lsb, msb, pbm, pop,
                                                  M, K, KP, E, stream,
                                                  rows)
                : launch_as<MODE, false, SCALE_IN>(x, s, col_mask, clip_l,
                                                   clip_h, lsb, msb, pbm,
                                                   pop, M, K, KP, E, stream,
                                                   rows);
}

// scale (M, 1) f32 in; lsb/msb int8 (M, K), pbm uint8 (M, K) or null,
// pop int32 (ceil(M/16), ceil(K/128)).
extern "C" int sparqle_encode_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, void* stream) {
  return launch<MODE_ENCODE, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, K,
                                   stream);
}

// q (M, K) int8 only.
extern "C" int sparqle_quantize_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, void* stream) {
  return launch<MODE_QUANTIZE, true>(x, x_bf16, scale, col_mask, clip_l,
                                     clip_h, q, nullptr, nullptr, nullptr,
                                     M, K, K, stream);
}

// KP = K padded to a multiple of 32; outputs (M, KP/2) x2, (M, KP/32)
// words and (ceil(M/16), ceil(K/128)) populations.
extern "C" int sparqle_encode_packed_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, void* stream) {
  return launch<MODE_PACKED, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, KP,
                                   stream);
}

// scale (M, 1) f32 out; the rest as sparqle_encode_launch's.
extern "C" int sparqle_encode_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, void* stream) {
  return launch<MODE_ENCODE, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, K,
                                    stream);
}

extern "C" int sparqle_quantize_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, void* stream) {
  return launch<MODE_QUANTIZE, false>(x, x_bf16, scale, col_mask, clip_l,
                                      clip_h, q, nullptr, nullptr, nullptr,
                                      M, K, K, stream);
}

extern "C" int sparqle_encode_packed_fused_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, void* stream) {
  return launch<MODE_PACKED, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, KP,
                                    stream);
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
    int M, int K, int E, const void* rows, void* stream) {
  return launch<MODE_ENCODE, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, K,
                                   stream, E, rows);
}

extern "C" int sparqle_quantize_batched_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, int E, const void* rows,
    void* stream) {
  return launch<MODE_QUANTIZE, true>(x, x_bf16, scale, col_mask, clip_l,
                                     clip_h, q, nullptr, nullptr, nullptr,
                                     M, K, K, stream, E, rows);
}

extern "C" int sparqle_encode_packed_batched_launch(
    const void* x, int x_bf16, const void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, int E, const void* rows, void* stream) {
  return launch<MODE_PACKED, true>(x, x_bf16, scale, col_mask, clip_l,
                                   clip_h, lsb, msb, pbm, pop, M, K, KP,
                                   stream, E, rows);
}

// The expert-batched forms of the three fused entries: x (E, M, K),
// col_mask (E, K) or null, every output with a leading E axis, rows as
// above; one launch encodes all E experts (grid z).
extern "C" int sparqle_encode_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int E, const void* rows, void* stream) {
  return launch<MODE_ENCODE, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, K,
                                    stream, E, rows);
}

extern "C" int sparqle_quantize_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* q, int M, int K, int E, const void* rows,
    void* stream) {
  return launch<MODE_QUANTIZE, false>(x, x_bf16, scale, col_mask, clip_l,
                                      clip_h, q, nullptr, nullptr, nullptr,
                                      M, K, K, stream, E, rows);
}

extern "C" int sparqle_encode_packed_fused_batched_launch(
    const void* x, int x_bf16, void* scale, const void* col_mask,
    int clip_l, int clip_h, void* lsb, void* msb, void* pbm, void* pop,
    int M, int K, int KP, int E, const void* rows, void* stream) {
  return launch<MODE_PACKED, false>(x, x_bf16, scale, col_mask, clip_l,
                                    clip_h, lsb, msb, pbm, pop, M, K, KP,
                                    stream, E, rows);
}

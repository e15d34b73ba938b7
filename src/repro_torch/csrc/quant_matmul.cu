// Dense single-pass W4A8 matmul for Hopper (sm_90a): the paper's
// iso-MAC dense baseline accelerator.
//
// Replaces the Pallas kernel `repro/kernels/quant_matmul.py`
// `quant_matmul` (`_kernel`):
//   acc = q @ w                              (one int8 x int4 pass)
//   out = float(acc) * act_scale * w_scale   (or the raw int32 acc)
// where q is the clipped int8 activation. Unlike the Pallas kernel,
// which takes an int8 `w`, it takes the int4 weight PACKED two per byte
// along K (`qlinear.pack_int4`, (K/2, N)): the layout the served tree
// holds and the dual-pass kernel reads. Since every int8 q is exactly
// 16 * msb4 + lsb4, its accumulator equals the dual-pass one bit for bit.
//
// Bound: bytes at the serving shapes (M <= 32): the packed weight stream
// dominates. Design: the tiling, weight unpack, `__dp4a` pass, exact
// split-K and drain of `w4a8_tile.cuh` (the dual-pass kernel's before it
// moved to tensor cores) with one activation plane. No mma, cp.async or
// TMA yet.
#include "w4a8_tile.cuh"

__global__ void quant_matmul_kernel(const int8_t* __restrict__ q,
                                    const int8_t* __restrict__ wp,
                                    int32_t* __restrict__ acc_buf, int M,
                                    int N, int K, int tiles_per_split) {
  __shared__ __align__(16) weight_tile w_s;
  __shared__ __align__(16) act_tile a_s;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_kt = (K + BK - 1) / BK;
  const int kt_lo = blockIdx.z * tiles_per_split;
  const int kt_hi = min(n_kt, kt_lo + tiles_per_split);
  const int tn = threadIdx.x % BN, mg = threadIdx.x / BN;   // 64 x 4
  int acc[4] = {0, 0, 0, 0};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    load_weight_tile(wp, w_s, kt, n0, N, K / 2);
    load_act_tile(q, a_s, m0, kt * BK, M, K);
    __syncthreads();
    dp4a_tile(w_s, a_s, tn, mg, acc);
    __syncthreads();
  }
  store_acc(acc_buf, acc, m0, mg, n0 + tn, M, N);
}

// acc_buf must be zero-filled when splits > 1; out == nullptr skips the
// drain (the caller wants the raw int32 accumulator).
extern "C" int quant_matmul_launch(const void* q, const void* wp,
                                   const void* act_scale,
                                   const void* w_scale, void* acc_buf,
                                   void* out, int M, int N, int K,
                                   int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int per;
  const dim3 grid = w4a8_grid(M, N, K, splits, &per);
  quant_matmul_kernel<<<grid, THREADS, 0, s>>>(
      (const int8_t*)q, (const int8_t*)wp, (int32_t*)acc_buf, M, N, K, per);
  return w4a8_drain(acc_buf, act_scale, w_scale, out, M, N, s);
}

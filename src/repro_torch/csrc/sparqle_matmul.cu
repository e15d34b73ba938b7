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
// products, split-K with an exact atomic int32 meet and a separate drain
// (all in `w4a8_tile.cuh`, shared with the dense baseline). No wgmma or
// TMA yet.
//
// The draft entry `sparqle_matmul_draft_launch` replaces the Pallas
// `_kernel_draft` (`sparqle_matmul(msb_skip=True)`): the same kernel
// instantiated with MSB_SKIP = true computes acc = lsb4 @ w alone. The
// MSB plane and the tile populations are not arguments of that entry at
// all, so it streams only the LSB plane and the weight (the Pallas
// draft grid likewise drops both operands); the drain is shared.
//
// The packed entries replace the Pallas `sparqle_matmul_packed`
// (`_kernel_packed`) and its draft (`_kernel_packed_draft`): the same
// kernel instantiated with PACKED = true reads the activation planes in
// the wire layout, (M, pad_k(K)/2) two nibbles per byte at the explicit
// row stride ldp, and unpacks them into the same shared-memory tiles
// (`load_act_tile_packed`), the MSB plane only for a tile whose
// population is > 0. The weight unpack, the `__dp4a` body, the split-K
// store and the drain are one source for both layouts, so the packed
// and unpacked accumulators are equal by construction. Bound: bytes, as
// the unpacked form; the activation planes cross device memory at half
// their unpacked bytes, which at decode is ~0.1% of the weight stream.
#include "w4a8_tile.cuh"

// MSB_SKIP: the draft's LSB-only pass; msb and tile_pop are never read.
// PACKED: lsb/msb are wire-layout planes of row stride ldp bytes (the
// unpacked planes have row stride K and ignore ldp).
template <bool MSB_SKIP, bool PACKED>
__global__ void sparqle_matmul_kernel(
    const int8_t* __restrict__ lsb, const int8_t* __restrict__ msb,
    const int32_t* __restrict__ tile_pop, const int8_t* __restrict__ wp,
    int32_t* __restrict__ acc_buf, int M, int N, int K, int ldp,
    int tiles_per_split) {
  __shared__ __align__(16) weight_tile w_s;
  __shared__ __align__(16) act_tile a_l;
  __shared__ __align__(16) int8_t a_m[MSB_SKIP ? 1 : BM][BK];
  const int n0 = blockIdx.x * BN, mt = blockIdx.y, m0 = mt * BM;
  const int n_kt = (K + BK - 1) / BK;
  const int kt_lo = blockIdx.z * tiles_per_split;
  const int kt_hi = min(n_kt, kt_lo + tiles_per_split);
  const int tn = threadIdx.x % BN, mg = threadIdx.x / BN;   // 64 x 4
  int acc_l[4] = {0, 0, 0, 0}, acc_m[4] = {0, 0, 0, 0};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    // uniform over the block; the draft has no MSB pass to gate
    const int pop = MSB_SKIP ? 0 : tile_pop[mt * n_kt + kt];
    load_weight_tile(wp, w_s, kt, n0, N, K / 2);
    if (PACKED) load_act_tile_packed<false>(lsb, a_l, m0, kt * BK, M, ldp);
    else load_act_tile(lsb, a_l, m0, kt * BK, M, K);
    if (!MSB_SKIP && pop > 0) {
      if (PACKED) load_act_tile_packed<true>(msb, a_m, m0, kt * BK, M, ldp);
      else load_act_tile(msb, a_m, m0, kt * BK, M, K);
    }
    __syncthreads();
    dp4a_tile(w_s, a_l, tn, mg, acc_l);
    if (!MSB_SKIP && pop > 0) dp4a_tile(w_s, a_m, tn, mg, acc_m);
    __syncthreads();
  }
  int part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) part[i] = acc_l[i] + acc_m[i] * 16;  // << 4
  store_acc(acc_buf, part, m0, mg, n0 + tn, M, N);
}

template <bool MSB_SKIP, bool PACKED>
static int launch(const void* lsb, const void* msb, const void* tile_pop,
                  const void* wp, const void* act_scale,
                  const void* w_scale, void* acc_buf, void* out, int M,
                  int N, int K, int ldp, int splits, cudaStream_t s) {
  int per;
  const dim3 grid = w4a8_grid(M, N, K, splits, &per);
  sparqle_matmul_kernel<MSB_SKIP, PACKED><<<grid, THREADS, 0, s>>>(
      (const int8_t*)lsb, (const int8_t*)msb, (const int32_t*)tile_pop,
      (const int8_t*)wp, (int32_t*)acc_buf, M, N, K, ldp, per);
  return w4a8_drain(acc_buf, act_scale, w_scale, out, M, N, s);
}

// acc_buf must be zero-filled when splits > 1; out == nullptr skips the
// drain (the caller wants the raw int32 accumulator).
extern "C" int sparqle_matmul_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* acc_buf, void* out,
    int M, int N, int K, int splits, void* stream) {
  return launch<false, false>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                              acc_buf, out, M, N, K, K, splits,
                              (cudaStream_t)stream);
}

// The LSB4-only draft: no MSB plane, no tile populations.
extern "C" int sparqle_matmul_draft_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* acc_buf, void* out, int M, int N, int K,
    int splits, void* stream) {
  return launch<true, false>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                             acc_buf, out, M, N, K, K, splits,
                             (cudaStream_t)stream);
}

// The wire-layout planes (M, ldp) with ldp = pad_k(K)/2.
extern "C" int sparqle_matmul_packed_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* acc_buf, void* out,
    int M, int N, int K, int ldp, int splits, void* stream) {
  return launch<false, true>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                             acc_buf, out, M, N, K, ldp, splits,
                             (cudaStream_t)stream);
}

// The LSB4-only draft on the wire-layout LSB plane.
extern "C" int sparqle_matmul_packed_draft_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* acc_buf, void* out, int M, int N, int K,
    int ldp, int splits, void* stream) {
  return launch<true, true>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                            acc_buf, out, M, N, K, ldp, splits,
                            (cudaStream_t)stream);
}

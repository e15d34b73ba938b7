// SPARQLe dual-pass W4A8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/sparqle_matmul.py`
// `sparqle_matmul` (`_kernel` -> `_tile_body` / `_drain`):
//   acc  = lsb4 @ w                          (dense LSB pass, every tile)
//   acc += (msb4 @ w) << 4                   (only where tile_pop > 0)
//   out  = (f32(acc) * act_scale) * w_scale  (or the raw int32 acc)
// It takes the int4 weight PACKED two per byte along K
// (`qlinear.pack_int4`, (K/2, N) int8), so only K*N/2 weight bytes cross
// device memory.
//
// What bounds it on the H100. At the serving shapes (M <= 32 rows:
// decode, the verify window, a prefill chunk) the packed weight stream:
// 29.4 MB at 4096 -> 14336 against at most 0.9 MB of activations and
// output, so bytes, 8.9 us at 3.35 TB/s. The design keeps that stream
// flowing and spends few instructions a weight byte:
//  * a ring of STAGES shared-memory stages fed by TMA (one
//    `cp.async.bulk.tensor` a tile, completing on the stage's mbarrier):
//    each block keeps STAGES - 1 K tiles of packed weight (4 KB each) and
//    of activation rows in flight while its warps compute, and the launch
//    plan (`kernels/sparqle_matmul.py` `launch_plan`) splits K until the
//    grid holds >= 264 blocks (two or more per SM). One thread issues a
//    stage with one arrive.expect_tx; where TMA cannot take an operand
//    (a row stride not a multiple of 16 B: N = 70, K = 4100) every thread
//    copies it with `cp.async.cg` 16 B (commit/wait groups) instead;
//  * the weight stays packed in shared memory, in the 64-byte swizzle the
//    TMA writes; `ldmatrix.trans` hands each lane the bytes of two
//    columns x four k-pair rows, `__byte_perm` splits them per column, and
//    masks and shifts place each nibble in the high half of a byte: the
//    operand is 16 * w, exact in s8 with its sign, so no sign extension is
//    spent; the int32 sum is 16 x the product and an arithmetic shift by 4
//    ends it exactly. Bound: on the planes a k adds at most
//    16 x (15 + 128) x 8 to |16 acc|, so int32 holds it up to K = 117,323;
//    on a full-range int8 q (the dense entry) a k adds at most
//    |q x 16 w| <= 128 x 128 = 2^14, so up to K = 131,071 (q = -128,
//    w = -8 reach 2^31 at K = 131,072). The wrappers take K <= 65,536;
//  * int8 tensor cores: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`
//    with the weight as the A operand (16 columns an mma) and the
//    activation rows as B (8 rows an mma), so decode's 8 rows fill an
//    mma. A 128-deep K tile is four k32 steps; an (m16, k128) population
//    tile is two n8 activation tiles, so the MSB pass is gated per warp
//    and per tile uniformly. LSB4 (0..15) and 16 * MSB4 (-128..112) are
//    both exact in s8: the MSB pass is an mma of the operand msb4 << 4
//    into the same accumulator, acc += (msb4 @ w) << 4 exactly (int32
//    sums are exact in any order). The MSB tile is fetched only where
//    the block's population row (read ahead into shared memory) is > 0;
//  * a block covers up to MT = 4 m16 tiles (64 rows), each gated by its
//    own population, so a 32-row chunk reads the weight once and the
//    1,024-row `--legacy` prefill 16 times; an expert-batched call of at
//    most 16 rows an expert runs the instance of one m16 tile a block
//    (`launch`), whose fewer registers fit 6 blocks an SM;
//  * one launch a call: with one K split the epilogue drains directly;
//    with several each split writes its int32 partial to its own slice
//    of a workspace, and the last block to arrive at an output tile (an
//    acq_rel arrival counter) sums the slices, drains or writes the int32
//    sum, and resets the counter to 0. A tile with no live row (below)
//    touches no counter: split 0 alone writes it, the other splits
//    return, so every counter is 0 again after every launch;
//  * the expert-batched entries take `rows` ((E,) int32 on the device, or
//    null: every row live): expert e's rows at and past rows[e] are taken
//    as zero, whatever the planes hold. A block whose row block starts at
//    or past rows[e] reads no population and issues no TMA: it writes the
//    drain of a zero accumulator, (f32(0) * act_scale) * w_scale or int32
//    0, and returns, so an expert the dispatch left empty streams none of
//    its weight. A live block stages and multiplies only its live m16 and
//    n8 tiles; the rows past rows[e] inside the last live n8 tile are
//    independent output rows of the mma (activation rows are its N), so
//    their accumulators are zeroed before the epilogue instead of masking
//    every fragment of the loop.
// From M = 64 rows up (the 1,024-token prefill) the int8 operations bound
// it; mma.sync runs that regime too (wgmma is a later step).
//
// Fragment order. An integer dot product does not depend on the order
// of K, so inside each 128-wide K tile the kernel uses a fixed
// permutation of K, the same for both operands: in k32 step s, lane
// (g, t) = (lane / 4, lane % 4) holds logical k = 4t + i (i = 0..3) =
// the low nibble of packed row 16s + 2t + (i & 1) + 8(i >> 1), real k
// 32s + 4t + 2(i & 1) + 16(i >> 1), and logical k = 16 + 4t + i = the
// high nibble of the same row, real k + 1. Output columns are permuted
// inside each warp's 32: row R of the weight operand's m16 tile u is
// real column 16u + 2(R % 8) + R / 8, so a lane holds two neighbouring
// columns (16u + 2g, + 1) and the epilogue stores them as pairs.
// `kernels/sparqle_matmul.py` (`k_order`, `n_order`, `w_off`, `a_off`)
// mirrors the orders and the swizzles.
//
// The draft entry `sparqle_matmul_draft_launch` replaces the Pallas
// `_kernel_draft` (`sparqle_matmul(msb_skip=True)`): the instance with
// MSB_SKIP = true computes acc = lsb4 @ w alone and takes neither the
// MSB plane nor the tile populations. The packed entries replace the
// Pallas `sparqle_matmul_packed` (`_kernel_packed`) and its draft
// (`_kernel_packed_draft`): the instance with PACKED = true stages the
// wire-layout planes ((M, ldp) two nibbles per byte, ldp = pad_k(K)/2)
// as they are and splits their nibbles while it builds the B operand;
// the rest is one body, so packed and unpacked accumulators are equal by
// construction.
//
// The dense entry `quant_matmul_launch` replaces the Pallas kernel
// `repro/kernels/quant_matmul.py` `quant_matmul` (`_kernel`), the paper's
// iso-MAC dense baseline: acc = q @ w in one int8 x int4 pass, the same
// drain. It is the MSB_SKIP instance run on the clipped int8 q in place
// of the LSB plane: `act_frag<false, false>` passes the plane's bytes
// through unmasked, so a full-range s8 q is a valid B operand, and the
// one pass, the K-halves meet (exact division by 16) and the drain give
// acc = q @ w and (f32(acc) * act_scale) * w_scale bit for bit. No
// template parameter of its own: the draft's instance computes exactly
// that. Since q = 16 * msb4 + lsb4, its accumulator equals the dual
// pass's on the planes of the same q.
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 16;    // rows of one mma == TILE_M of the PBM population
constexpr int TILE_K = 128;   // K per tile == TILE_K of the PBM population
constexpr int MT = 4;         // m16 population tiles per block (MTB: 1 for
                              // a batched call of <= 16 rows an expert)
constexpr int BLOCK_N = 64;   // output columns per block: 2 warp columns x 32
constexpr int THREADS = 128;  // 2 column groups x 2 K halves
constexpr int STAGES = 4;
constexpr int W_STAGE = TILE_K / 2 * BLOCK_N;   // packed weight bytes a stage
constexpr int MAX_SMEM = 200 * 1024;   // opt-in, under the 227 KB a block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// rows of the m16 tiles that M rows occupy
__host__ __device__ constexpr int nmt_all(int M) { return cdiv(M, 16) * 16; }

// Shared-memory layouts, swizzled per 16 B chunk so that the fragment
// reads hit distinct banks (mirrored in kernels/sparqle_matmul.py).
// 64-byte rows (the packed weight: row r a k pair, byte column c of the
// block's 64 columns; the wire-layout planes): rows 2l, 2l + 1 share a
// 128 B line and bits 1-2 of r rotate the chunks, so any 8 consecutive
// rows of one chunk (an ldmatrix phase) fill all 32 banks.
__device__ __forceinline__ int w_off(int r, int c) {
  return r * 64 + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15);
}
// 128-byte rows (the unpacked planes): the chunk XOR the row's low bits.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// TMA: the copy of one box of a 2D tensor map (columns from x, rows
// from y; out-of-range bytes land as zeros) into dst, in the map's
// swizzle, counted on bar; expect_tx / arrive make up bar's phase.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
        "r"(y), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// 16 bytes from src into the shared chunk dst: by cp.async when the
// chunk is whole and aligned, else the first `valid` bytes (0..16) by
// plain loads and zeros after them (ragged or unaligned edges).
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src,
                                       int valid, bool vec) {
  if (vec && valid >= 16) {
    cp_async16(dst, src);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid) w[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Four 8 x 8 tiles of 16-bit elements, transposed: lane (g, t) gets
// elements (rows 2t, 2t + 1; column g) of tile q in r[q]. Lanes 8q .. 8q
// + 7 give the row addresses of tile q.
__device__ __forceinline__ void ldsm_x4_trans(const int8_t* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The activation operand (mma B, 32 k x 8 rows) of k32 step s for row
// r: b[0] byte i is real k 32s + 4t + 2(i & 1) + 16(i >> 1), b[1] byte i
// that k + 1. MSB: the operand 16 * msb4, exact in s8.
template <bool PACKED, bool MSB>
__device__ __forceinline__ void act_frag(const int8_t* plane, int r, int s,
                                         int t, uint32_t (&b)[2]) {
  if (PACKED) {   // byte j holds real k 2j (low nibble), 2j + 1 (high)
    const uint16_t* h0 = reinterpret_cast<const uint16_t*>(
        plane + w_off(r, 16 * s + 2 * t));
    const uint16_t* h1 = reinterpret_cast<const uint16_t*>(
        plane + w_off(r, 16 * s + 8 + 2 * t));
    const uint32_t v = __byte_perm(*h0, *h1, 0x5410);
    b[0] = MSB ? (v << 4) & 0xF0F0F0F0u : v & 0x0F0F0F0Fu;
    b[1] = MSB ? v & 0xF0F0F0F0u : (v >> 4) & 0x0F0F0F0Fu;
  } else {        // bytes 4t .. + 3 and 16 + 4t .. + 3: even k to b[0]
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(plane + a_off(r, 32 * s + 4 * t));
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        plane + a_off(r, 32 * s + 16 + 4 * t));
    b[0] = __byte_perm(u, v, 0x6420);
    b[1] = __byte_perm(u, v, 0x7531);
    if (MSB) {
      b[0] = (b[0] << 4) & 0xF0F0F0F0u;
      b[1] = (b[1] << 4) & 0xF0F0F0F0u;
    }
  }
}

// 2 int32 at dst (columns c, c + 1, those below N)
__device__ __forceinline__ void store2(int32_t* dst, int v0, int v1, int c,
                                       int N) {
  if (N % 2 == 0 && c + 2 <= N) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    if (c < N) dst[0] = v0;
    if (c + 1 < N) dst[1] = v1;
  }
}

// Row m, columns c .. c + 3 (those below N) of the result: the int32
// acc, or (f32(acc) * as) * wsc[e] in the reference's order (as: the
// row's act_scale, wsc: w_scale from column c on). 16 B stores where
// N % 4 == 0 and all four columns are real.
__device__ __forceinline__ void drain4(
    float* __restrict__ out, int32_t* __restrict__ acc_out, float as,
    const float* wsc, int m, int c, int N, const int* v) {
  const bool vec = N % 4 == 0 && c + 4 <= N;
  if (acc_out != nullptr) {
    int32_t* dst = acc_out + (long)m * N + c;
    if (vec) *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    else for (int e = 0; e < 4 && c + e < N; ++e) dst[e] = v[e];
    return;
  }
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = c + e < N ? __fmul_rn(__fmul_rn((float)v[e], as), wsc[e]) : 0.f;
  float* dst = out + (long)m * N + c;
  if (vec)
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  else for (int e = 0; e < 4 && c + e < N; ++e) dst[e] = o[e];
}

// Row m, columns c, c + 1 (those below N): as drain4.
__device__ __forceinline__ void drain2(
    float* __restrict__ out, int32_t* __restrict__ acc_out, float as,
    const float* wsc, int m, int c, int N, int v0, int v1) {
  if (acc_out != nullptr) {
    store2(acc_out + (long)m * N + c, v0, v1, c, N);
    return;
  }
  const float o0 = c < N ? __fmul_rn(__fmul_rn((float)v0, as), wsc[0]) : 0.f;
  const float o1 =
      c + 1 < N ? __fmul_rn(__fmul_rn((float)v1, as), wsc[1]) : 0.f;
  float* dst = out + (long)m * N + c;
  if (N % 2 == 0 && c + 2 <= N) {
    *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
  } else {
    if (c < N) dst[0] = o0;
    if (c + 1 < N) dst[1] = o1;
  }
}

// MSB_SKIP: the draft's LSB-only pass; msb and tile_pop are never read.
// PACKED: lsb/msb are wire-layout planes of row stride ldp bytes (the
// unpacked planes have row stride K and ignore ldp).
// Warps: 2 column groups of 32 x 2 K halves (k32 steps 0-1 and 2-3 of
// every K tile); the K halves meet in shared memory at the end.
// Expert-batched: grid y counts E x the row blocks of one expert's M
// rows; expert e = blockIdx.y / row blocks reads its own planes (rows
// eM.. of the (E M, lda) planes), populations, packed weight (rows eK/2..
// of the (E K/2, N) weight, so the tensor maps stay 2D) and scales, and
// writes its own (M, N) output and workspace slices. A weight box past
// the expert's K/2 rows reads the next expert's rows: their activation
// columns are past K, zero in every plane, so no product changes. With
// E = 1 every offset is 0.
template <bool MSB_SKIP, bool PACKED, int MTB>
__global__ void __launch_bounds__(THREADS) sparqle_matmul_kernel(
    const int8_t* __restrict__ lsb, const int8_t* __restrict__ msb,
    const int32_t* __restrict__ tile_pop, const int8_t* __restrict__ wp,
    const float* __restrict__ act_scale, const float* __restrict__ w_scale,
    float* __restrict__ out, int32_t* __restrict__ acc_out,
    int32_t* __restrict__ ws, int32_t* __restrict__ counters, int M, int N,
    int K, int ldp, int per, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap lmap,
    const __grid_constant__ CUtensorMap mmap, int tma_w, int tma_a,
    const int32_t* __restrict__ expert_rows) {
  constexpr int BM = MTB * TILE_M;                    // rows a block
  constexpr int NTB = BM / 8;                         // n8 row tiles
  constexpr int ROWB = PACKED ? TILE_K / 2 : TILE_K;  // plane bytes a tile row
  constexpr int PLANES = MSB_SKIP ? 1 : 2;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int s_last;
  __shared__ __align__(8) uint64_t bar[STAGES];    // TMA arrivals a stage
  __shared__ float as_s[BM], ws_s[BLOCK_N];     // the drain's scales

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = warp & 1, kh = warp >> 1;        // column group, K half
  const int g = lane >> 2, t = lane & 3;
  const int rbe = cdiv(M, BM);                // row blocks an expert
  const int e = blockIdx.y / rbe;
  const int n0 = blockIdx.x * BLOCK_N, m0 = (blockIdx.y % rbe) * BM;
  const int n_kt = cdiv(K, TILE_K);
  const int K2 = K / 2;
  const int lda = PACKED ? ldp : K;            // plane row stride, bytes
  {   // this expert's operands; the TMA rows are offset below
    const long rows_e = (long)e * M;
    lsb += rows_e * lda;
    if (msb != nullptr) msb += rows_e * lda;
    if (tile_pop != nullptr) tile_pop += (long)e * cdiv(M, TILE_M) * n_kt;
    wp += (long)e * K2 * N;
    act_scale += rows_e;
    w_scale += (long)e * N;
    if (out != nullptr) out += rows_e * N;
    if (acc_out != nullptr) acc_out += rows_e * N;
    if (ws != nullptr) ws += (long)e * gridDim.z * M * N;
  }
  const int rows = min(BM, M - m0);          // valid rows of the block
  // expert e's live rows (all M without `expert_rows`)
  const int live_m =
      expert_rows == nullptr ? M : min(max(expert_rows[e], 0), M);
  if (m0 >= live_m) {   // no live row: split 0 drains zero accumulators
    if (blockIdx.z != 0) return;
    const int zero[4] = {0, 0, 0, 0};
    for (int q = tid; q < rows * (BLOCK_N / 4); q += THREADS) {
      const int m = m0 + q / (BLOCK_N / 4), c = n0 + (q % (BLOCK_N / 4)) * 4;
      if (c < N)
        drain4(out, acc_out, act_scale[m], w_scale + c, m, c, N, zero);
    }
    return;
  }
  const int w_row0 = e * K2, a_row0 = e * M;   // TMA row offsets
  const int kt_lo = blockIdx.z * per;
  const int nk = min(n_kt, kt_lo + per) - kt_lo;
  const int live = min(rows, live_m - m0);        // live rows of the block
  const int nmt = cdiv(live, TILE_M);             // live m16 row tiles
  const int nnt = cdiv(live, 8);                  // live n8 row tiles
  const int nnt_out = cdiv(rows, 8);              // n8 row tiles drained
  const int arows = min(BM, nmt_all(M));    // staged rows a plane
  const int a_bytes = arows * ROWB;
  // stages start 1 KB-aligned: the TMA swizzle follows address bits
  const int stage = cdiv(W_STAGE + PLANES * a_bytes, 1024) * 1024;
  // live_s[i]: bit mt set where m16 tile mt of K tile kt_lo + i has
  // tile_pop > 0, i.e. its MSB plane is read
  uint8_t* live_s = reinterpret_cast<uint8_t*>(smem);
  const uint32_t s0 = smem_u32(smem);
  int8_t* ring = smem + ((s0 + (MSB_SKIP ? 0 : per) + 1023) & ~1023u) - s0;

  const bool w_vec = (N % 16 == 0) && ((uintptr_t)wp % 16 == 0);
  const bool a_vec = (lda % 16 == 0) && ((uintptr_t)lsb % 16 == 0) &&
                     (MSB_SKIP || (uintptr_t)msb % 16 == 0);

  const bool tma = tma_w || tma_a;
  // the m16 tiles of K tile kt_lo + i whose MSB plane is read (pop > 0),
  // straight from tile_pop (live_s holds them once the block has them)
  auto live_mask = [&](int i) {
    uint32_t live = 0;
#pragma unroll
    for (int mt = 0; mt < MTB; ++mt)
      if (!MSB_SKIP && mt < nmt &&
          tile_pop[(m0 / TILE_M + mt) * n_kt + kt_lo + i] > 0)
        live |= 1u << mt;
    return live;
  };
  // thread 0's TMA part of stage st (K tile kt_lo + i): part 0 the
  // weight and LSB tiles, part 1 the MSB tiles of the live m16 tiles and
  // the stage's one arrival; part 2 both, with one arrive.expect_tx
  auto tma_part = [&](int st, int i, int part, uint32_t live) {
    const int kt = kt_lo + i;
    int8_t* w_s = ring + st * stage;
    const uint32_t lsb_bytes = (tma_w ? W_STAGE : 0) +
                               (tma_a ? nmt * TILE_M * ROWB : 0);
    const uint32_t msb_bytes =
        !MSB_SKIP && tma_a ? __popc(live) * TILE_M * ROWB : 0;
    if (part == 2) mbar_arrive_expect(&bar[st], lsb_bytes + msb_bytes);
    if (part != 1) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (part == 0) mbar_expect(&bar[st], lsb_bytes);
      if (tma_w)
        tma_2d(w_s, &wmap, n0, w_row0 + kt * (TILE_K / 2), &bar[st]);
#pragma unroll
      for (int mt = 0; mt < MTB; ++mt)
        if (tma_a && mt < nmt)
          tma_2d(w_s + W_STAGE + mt * TILE_M * ROWB, &lmap, kt * ROWB,
                 a_row0 + m0 + mt * TILE_M, &bar[st]);
      if (part == 0) return;
    }
    if (part == 1) mbar_expect(&bar[st], msb_bytes);
#pragma unroll
    for (int mt = 0; mt < MTB; ++mt)
      if (!MSB_SKIP && tma_a && ((live >> mt) & 1))
        tma_2d(w_s + W_STAGE + a_bytes + mt * TILE_M * ROWB, &mmap,
               kt * ROWB, a_row0 + m0 + mt * TILE_M, &bar[st]);
    if (part == 1) mbar_arrive(&bar[st]);
  };
  auto load_w = [&](int st, int i) {
    const int kt = kt_lo + i;
    int8_t* w_s = ring + st * stage;
    for (int q = tid; q < W_STAGE / 16; q += THREADS) {
      const int r = q >> 2, c = (q & 3) * 16;
      const int k2 = kt * (TILE_K / 2) + r, n = n0 + c;
      const int valid = k2 < K2 ? max(0, min(16, N - n)) : 0;
      copy16(w_s + w_off(r, c), wp + (long)k2 * N + n, valid, w_vec);
    }
  };
  auto load_a = [&](int st, int i, int p_lo, int p_hi) {
    const int kt = kt_lo + i;
    constexpr int CH = ROWB / 16;              // 16 B chunks a plane row
    for (int p = p_lo; p < p_hi; ++p) {
      const int8_t* src = p ? msb : lsb;
      int8_t* a_s = ring + st * stage + W_STAGE + p * a_bytes;
      for (int q = tid; q < live * CH; q += THREADS) {
        const int r = q / CH, c = (q % CH) * 16;
        if (p && !((live_s[i] >> (r / TILE_M)) & 1)) continue;
        const int k = kt * ROWB + c;
        // the unpacked planes end at K; the wire rows run to ldp
        const int valid = max(0, min(16, lda - k));
        copy16(a_s + (PACKED ? w_off(r, c) : a_off(r, c)),
               src + (long)(m0 + r) * lda + k, valid, a_vec);
      }
    }
  };

  // the first stages are in flight while the block reads its
  // populations ahead and, without TMA, zeroes the rows past M in every
  // stage; thread 0 reads the populations of those stages itself, so
  // that their MSB tiles need not wait for the block
  if (tma && tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&bar[st]);
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p)
      if (p < nk) tma_part(p, p, 0, 0);
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p)
      if (p < nk) tma_part(p, p, 1, tma_a ? live_mask(p) : 0);
  }
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p)
    if (p < nk) {
      if (!tma_w) load_w(p, p);
      if (!tma_a) load_a(p, p, 0, 1);
    }
  for (int i = tid; i < BM + BLOCK_N; i += THREADS) {
    if (i < rows) as_s[i] = act_scale[m0 + i];
    const int c = i - BM;
    if (c >= 0 && n0 + c < N) ws_s[c] = w_scale[n0 + c];
  }
  if (!MSB_SKIP)
    for (int i = tid; i < per; i += THREADS)
      live_s[i] = i < nk ? live_mask(i) : 0;
  for (int st = 0; st < STAGES && !tma_a; ++st)
    for (int p = 0; p < PLANES; ++p) {
      int8_t* a = ring + st * stage + W_STAGE + p * a_bytes;
      for (int i = live * ROWB + 4 * tid; i < nmt * TILE_M * ROWB;
           i += 4 * THREADS)
        *reinterpret_cast<uint32_t*>(a + i) = 0u;
    }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk && !tma_a) load_a(p, p, 1, PLANES);
    cp_async_commit();
  }

  // acc[u][nt]: weight rows (columns) of m16 tile u x activation rows of
  // n8 tile nt, as 16 x the sum (the weight operand is 16 * w)
  int acc[2][NTB][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0;

  // this lane's ldmatrix row: tile q = lane / 8 is packed rows 8(q & 1)
  // .. + 7 of the k32 step, bytes 16(q >> 1) .. + 15 of the warp's 32
  // columns (each k32 step adds 16 rows = 1,024 bytes)
  const int q8 = lane >> 3;
  const int ldsm = w_off(8 * (q8 & 1) + (lane & 7), cg * 32 + 16 * (q8 >> 1))
                   + 2048 * kh;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    if (tma) mbar_wait(&bar[i % STAGES], (i / STAGES) & 1);
    __syncthreads();
    if (i + STAGES - 1 < nk) {
      const int st = (i + STAGES - 1) % STAGES;
      if (tma && tid == 0)
        tma_part(st, i + STAGES - 1, 2, MSB_SKIP ? 0 : live_s[i + STAGES - 1]);
      if (!tma_w) load_w(st, i + STAGES - 1);
      if (!tma_a) load_a(st, i + STAGES - 1, 0, PLANES);
    }
    cp_async_commit();

    const int8_t* w_s = ring + (i % STAGES) * stage;
    const int8_t* a_l = w_s + W_STAGE;
    const int8_t* a_m = a_l + a_bytes;
    const uint32_t live = MSB_SKIP ? 0 : live_s[i];
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      const int s = 2 * kh + ss;
      // r[q]: bytes (row 2t, col 2g), (2t, 2g + 1), (2t + 1, 2g),
      // (2t + 1, 2g + 1) of tile q; col[c] = packed rows 2t, 2t + 1,
      // 2t + 8, 2t + 9 of column 16(c >> 1) + 2g + (c & 1)
      uint32_t r[4];
      ldsm_x4_trans(w_s + ldsm + 1024 * ss, r);
      const uint32_t col[4] = {__byte_perm(r[0], r[1], 0x6420),
                               __byte_perm(r[0], r[1], 0x7531),
                               __byte_perm(r[2], r[3], 0x6420),
                               __byte_perm(r[2], r[3], 0x7531)};
      // the weight operand of m16 tile u: row g is column 16u + 2g, row
      // g + 8 column 16u + 2g + 1; low nibbles (even k) shifted up, high
      // nibbles masked: 16 * w in s8, sign included
      uint32_t wa[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        wa[u][0] = (col[2 * u] << 4) & 0xF0F0F0F0u;
        wa[u][1] = (col[2 * u + 1] << 4) & 0xF0F0F0F0u;
        wa[u][2] = col[2 * u] & 0xF0F0F0F0u;
        wa[u][3] = col[2 * u + 1] & 0xF0F0F0F0u;
      }
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt) {
        if (nt >= nnt) break;
        uint32_t b[2];
        act_frag<PACKED, false>(a_l, 8 * nt + g, s, t, b);
        mma_s8(acc[0][nt], wa[0], b[0], b[1]);
        mma_s8(acc[1][nt], wa[1], b[0], b[1]);
        if ((live >> (nt >> 1)) & 1) {
          act_frag<PACKED, true>(a_m, 8 * nt + g, s, t, b);
          mma_s8(acc[0][nt], wa[0], b[0], b[1]);
          mma_s8(acc[1][nt], wa[1], b[0], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the K halves meet: half 1 hands its accumulators to half 0 through
  // the (now idle) ring, lane-minor (conflict-free); then 16 x the sum
  // becomes the sum, exactly
  int* red = reinterpret_cast<int*>(ring);
  if (kh == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt < nnt) red[((u * NTB + nt) * 4 + e) * 64 + tid - 64] =
              acc[u][nt][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt < nnt)
            acc[u][nt][e] = (acc[u][nt][e] +
                             red[((u * NTB + nt) * 4 + e) * 64 + tid]) >> 4;
    // rows at and past the live count are zero rows: their products
    // (of whatever the stage held there) are dropped
    if (live < rows) {
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nt + 2 * t + e < live) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) acc[u][nt][e] = acc[u][nt][2 + e] = 0;
        }
      }
    }
  }

  // lane (g, t) of half 0 holds, for m16 tile u and n8 tile nt, rows
  // 8nt + 2t (c0, c2) and 8nt + 2t + 1 (c1, c3) at columns cu, cu + 1,
  // cu = n0 + 32cg + 16u + 2g
  if (gridDim.z > 1) {
    if (kh == 0) {
      int32_t* slice = ws + (long)blockIdx.z * M * N;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * nt + 2 * t + e;
            const int c = n0 + cg * 32 + 16 * u + 2 * g;
            if (nt >= nnt_out || m >= M) continue;
            store2(slice + (long)m * N + c, acc[u][nt][e], acc[u][nt][2 + e],
                   c, N);
          }
    }
    // the block's slice, seen by thread 0 through the barrier, is
    // released to the device with the arrival (acq_rel: the last block
    // acquires every other slice with it)
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev) : "l"(counters + tile) : "memory");
      s_last = prev == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!s_last) return;
    // the last block: every thread sums 4 columns of one row over all
    // the slices (its own included) and drains them
    const bool vec4 = N % 4 == 0;
    for (int q = tid; q < rows * (BLOCK_N / 4); q += THREADS) {
      const int m = m0 + q / (BLOCK_N / 4), c = n0 + (q % (BLOCK_N / 4)) * 4;
      if (c >= N) continue;
      int v[4] = {0, 0, 0, 0};
      const int32_t* src = ws + (long)m * N + c;
      const long step = (long)M * N;
      if (vec4) {
#pragma unroll 16
        for (int z = 0; z < (int)gridDim.z; ++z) {
          const int4 p = __ldcg(reinterpret_cast<const int4*>(src + z * step));
          v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
        }
      } else {
        for (int z = 0; z < (int)gridDim.z; ++z)
          for (int e = 0; e < 4; ++e)
            if (c + e < N) v[e] += __ldcg(src + z * step + e);
      }
      drain4(out, acc_out, as_s[m - m0], ws_s + (c - n0), m, c, N, v);
    }
    if (tid == 0) counters[tile] = 0;
    return;
  }
  if (kh == 1) return;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * nt + 2 * t + e;
        if (nt >= nnt_out || m >= M) continue;
        const int c = cg * 32 + 16 * u + 2 * g;
        drain2(out, acc_out, as_s[m - m0], ws_s + c, m, n0 + c, N,
               acc[u][nt][e], acc[u][nt][2 + e]);
      }
}

// Dynamic shared memory of one block: the populations, then STAGES x
// (packed weight tile + the activation plane tiles of up to MTB x 16
// rows), each stage 1 KB-aligned.
template <bool MSB_SKIP, bool PACKED, int MTB>
size_t smem_bytes(int M, int per) {
  const int rowb = PACKED ? TILE_K / 2 : TILE_K;
  const int bm = MTB * TILE_M;
  const int arows = nmt_all(M) < bm ? nmt_all(M) : bm;
  const int stage = cdiv(W_STAGE + (MSB_SKIP ? 1 : 2) * arows * rowb, 1024);
  return (size_t)(MSB_SKIP ? 0 : per) + 1024 +
         (size_t)STAGES * stage * 1024;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 2D TMA descriptor over a row-major byte matrix (rows x cols, row
// stride `stride` bytes), boxes of box_c x box_r. False where TMA cannot
// take it (a stride not a multiple of 16, an unaligned base); the kernel
// then copies that operand with cp.async.
bool tma_map(CUtensorMap* map, const void* base, long rows, long cols,
             long stride, int box_c, int box_r, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return false;
    encode = (EncodeTiled)fn;
  }
  if (stride % 16 != 0 || (uintptr_t)base % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MSB_SKIP, bool PACKED, int MTB>
int launch_mt(const void* lsb, const void* msb, const void* tile_pop,
              const void* wp, const void* act_scale, const void* w_scale,
              void* out, void* acc_out, void* ws, void* counters, int M,
              int N, int K, int ldp, int per, cudaStream_t s, int E,
              const void* expert_rows) {
  static bool attr_set = false;   // above 48 KB needs the opt-in, once
  auto kernel = sparqle_matmul_kernel<MSB_SKIP, PACKED, MTB>;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // the weight (K/2, N) in 64 x 64 boxes, the planes (M, lda) in 16-row
  // boxes of one K tile, swizzled as w_off / a_off lay them out
  CUtensorMap wmap = {}, lmap = {}, mmap = {};
  const int tma_w = tma_map(&wmap, wp, (long)E * (K / 2), N, N, BLOCK_N,
                            TILE_K / 2, CU_TENSOR_MAP_SWIZZLE_64B);
  const int lda = PACKED ? ldp : K, rowb = PACKED ? TILE_K / 2 : TILE_K;
  const CUtensorMapSwizzle asw =
      PACKED ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const int tma_a =
      tma_map(&lmap, lsb, (long)E * M, lda, lda, rowb, TILE_M, asw) &&
      (MSB_SKIP ||
       tma_map(&mmap, msb, (long)E * M, lda, lda, rowb, TILE_M, asw));
  const dim3 grid(cdiv(N, BLOCK_N), E * cdiv(M, MTB * TILE_M),
                  cdiv(cdiv(K, TILE_K), per));
  kernel<<<grid, THREADS, smem_bytes<MSB_SKIP, PACKED, MTB>(M, per), s>>>(
      (const int8_t*)lsb, (const int8_t*)msb, (const int32_t*)tile_pop,
      (const int8_t*)wp, (const float*)act_scale, (const float*)w_scale,
      (float*)out, (int32_t*)acc_out, (int32_t*)ws, (int32_t*)counters, M,
      N, K, ldp, per, wmap, lmap, mmap, tma_w, tma_a,
      (const int32_t*)expert_rows);
  return (int)cudaGetLastError();
}

// The body's instance for a call: MT m16 tiles a block, or, for an
// expert-batched call of at most 16 rows an expert (a routed projection
// at decode), one: the same grid (one row block an expert either way),
// a quarter of the accumulators, so its lower register count lets 6
// blocks share an SM where the MT instance's 109-120 registers a thread
// hold 4 (the waves of resident blocks set the time there:
// tools/rows_probe.py).
template <bool MSB_SKIP, bool PACKED>
int launch(const void* lsb, const void* msb, const void* tile_pop,
           const void* wp, const void* act_scale, const void* w_scale,
           void* out, void* acc_out, void* ws, void* counters, int M, int N,
           int K, int ldp, int per, cudaStream_t s, int E = 1,
           const void* expert_rows = nullptr, bool batched = false) {
  if (batched && M <= TILE_M)
    return launch_mt<MSB_SKIP, PACKED, 1>(
        lsb, msb, tile_pop, wp, act_scale, w_scale, out, acc_out, ws,
        counters, M, N, K, ldp, per, s, E, expert_rows);
  return launch_mt<MSB_SKIP, PACKED, MT>(
      lsb, msb, tile_pop, wp, act_scale, w_scale, out, acc_out, ws,
      counters, M, N, K, ldp, per, s, E, expert_rows);
}

}  // namespace

// One launch a call. Exactly one of out (f32) and acc_out (int32) is
// non-null. per = K tiles a split (`launch_plan`); with more than one
// split, ws holds (splits, M, N) int32 (no fill needed) and counters one
// zeroed int a (row block, column block) tile, left zeroed again.
extern "C" int sparqle_matmul_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* out, void* acc_out,
    void* ws, void* counters, int M, int N, int K, int per, void* stream) {
  return launch<false, false>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                              out, acc_out, ws, counters, M, N, K, K, per,
                              (cudaStream_t)stream);
}

// The LSB4-only draft: no MSB plane, no tile populations.
extern "C" int sparqle_matmul_draft_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int per, void* stream) {
  return launch<true, false>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, K, per,
                             (cudaStream_t)stream);
}

// The dense single pass on the int8 q (M, K): the draft's instance with q
// in place of the LSB plane.
extern "C" int quant_matmul_launch(
    const void* q, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int per, void* stream) {
  return launch<true, false>(q, nullptr, nullptr, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, K, per,
                             (cudaStream_t)stream);
}

// The wire-layout planes (M, ldp) with ldp = pad_k(K)/2.
extern "C" int sparqle_matmul_packed_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* out, void* acc_out,
    void* ws, void* counters, int M, int N, int K, int ldp, int per,
    void* stream) {
  return launch<false, true>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, ldp, per,
                             (cudaStream_t)stream);
}

// The LSB4-only draft on the wire-layout LSB plane.
extern "C" int sparqle_matmul_packed_draft_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int ldp, int per, void* stream) {
  return launch<true, true>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                            out, acc_out, ws, counters, M, N, K, ldp, per,
                            (cudaStream_t)stream);
}

// The expert-batched forms of the five entries: planes (E, M, K) (or
// (E, M, ldp)), tile_pop (E, ceil(M/16), ceil(K/128)), the packed weight
// (E, K/2, N), act_scale (E, M, 1), w_scale (E, 1, N), the result (E, M,
// N); ws holds (E, splits, M, N) with more than one split, and counters
// one int a (expert, row block, column block) tile. One launch for all E.
// rows: (E,) int32 live rows an expert (rows at and past rows[e] taken
// as zero, their outputs the drain of 0), or null for all M.
extern "C" int sparqle_matmul_batched_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* out, void* acc_out,
    void* ws, void* counters, int M, int N, int K, int E, int per,
    const void* rows, void* stream) {
  return launch<false, false>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                              out, acc_out, ws, counters, M, N, K, K, per,
                              (cudaStream_t)stream, E, rows, true);
}

extern "C" int sparqle_matmul_draft_batched_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int E, int per, const void* rows,
    void* stream) {
  return launch<true, false>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, K, per,
                             (cudaStream_t)stream, E, rows, true);
}

extern "C" int quant_matmul_batched_launch(
    const void* q, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int E, int per, const void* rows,
    void* stream) {
  return launch<true, false>(q, nullptr, nullptr, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, K, per,
                             (cudaStream_t)stream, E, rows, true);
}

extern "C" int sparqle_matmul_packed_batched_launch(
    const void* lsb, const void* msb, const void* tile_pop, const void* wp,
    const void* act_scale, const void* w_scale, void* out, void* acc_out,
    void* ws, void* counters, int M, int N, int K, int E, int ldp, int per,
    const void* rows, void* stream) {
  return launch<false, true>(lsb, msb, tile_pop, wp, act_scale, w_scale,
                             out, acc_out, ws, counters, M, N, K, ldp, per,
                             (cudaStream_t)stream, E, rows, true);
}

extern "C" int sparqle_matmul_packed_draft_batched_launch(
    const void* lsb, const void* wp, const void* act_scale,
    const void* w_scale, void* out, void* acc_out, void* ws, void* counters,
    int M, int N, int K, int E, int ldp, int per, const void* rows,
    void* stream) {
  return launch<true, true>(lsb, nullptr, nullptr, wp, act_scale, w_scale,
                            out, acc_out, ws, counters, M, N, K, ldp, per,
                            (cudaStream_t)stream, E, rows, true);
}

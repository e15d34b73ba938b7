"""The W4A8 matmul body's launch plan and fragment order, on the CPU.

``csrc/sparqle_matmul.cu`` cannot run here, so its index arithmetic has
a plain-Python mirror in ``repro_torch.kernels.sparqle_matmul``: the
split plan, the blocks' tiles, the workspace and counter sizes, the K
and column permutations inside a tile and the shared-memory swizzles.
These tests hold that mirror to what the kernel needs: every (m16,
column, K tile) computed by exactly one block, buffers large enough, at
least two blocks per SM at the decode shapes, permutations that are
bijections and leave the integer product unchanged (exactly, on random
int8 with numpy), and fragment reads free of bank conflicts. The dense
entry runs the same body on a full-range int8 q: a numpy model of its
int32 arithmetic holds the bound the wrapper's ``MAX_K`` relies on, and
the dense wrapper's launch (recorded on the CPU) covers every tile once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import sparqle_matmul as S
from repro_torch.kernels.ref import TILE_K, TILE_M

GRANITE = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SHAPES = [(m, n, k) for m in (1, 8, 16, 17, 24, 32, 33, 64)
          for k, n in GRANITE + [(200, 70), (4100, 1024)]] + [
    (1024, 1024, 4096), (1024, 70, 200), (65, 130, 384), (100, 64, 128)]


def _blocks(plan):
    for bz in range(plan.splits):
        for by in range(plan.row_blocks):
            for bx in range(plan.col_blocks):
                yield bx, by, bz


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_every_tile_covered_by_exactly_one_block(m, n, k):
    plan = S.launch_plan(m, n, k)
    n_mt = -(-m // TILE_M)
    count = np.zeros((n_mt, n, plan.n_kt), np.int32)
    for bx, by, bz in _blocks(plan):
        for mt, lo, hi, kt in S.block_tiles(plan, m, n, bx, by, bz):
            count[mt, lo:hi, kt] += 1
    assert (count == 1).all()
    # no split is empty, and per is balanced: the splits cover K exactly
    assert (plan.splits - 1) * plan.per < plan.n_kt <= plan.splits * plan.per


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_workspace_and_counters_suffice(m, n, k):
    plan = S.launch_plan(m, n, k)
    if plan.splits == 1:
        assert plan.workspace(m, n) == 0 and plan.counters == 0
        return
    # each split writes its own (M, N) int32 slice
    assert plan.workspace(m, n) >= plan.splits * m * n
    # the kernel's tile index by * gridDim.x + bx fits the device's
    # counter buffer (TARGET_BLOCKS ints, allocated once)
    tiles = {by * plan.col_blocks + bx for bx, by, _ in _blocks(plan)}
    assert max(tiles) < plan.counters <= S.TARGET_BLOCKS


@pytest.mark.parametrize("m", [1, 8, 24, 32])
@pytest.mark.parametrize("k,n", GRANITE)
def test_decode_shapes_run_two_blocks_per_sm(m, k, n):
    assert S.launch_plan(m, n, k).blocks >= 2 * 132


def test_weight_read_once_per_64_rows():
    # a 32-row prefill chunk is one row block, the 1,024-token prefill 16
    assert S.launch_plan(32, 14336, 4096).row_blocks == 1
    assert S.launch_plan(1024, 14336, 4096).row_blocks == 16


def test_k_and_column_orders_are_bijections():
    order = S.k_order()
    assert len(order) == TILE_K
    for s in range(4):   # each k32 step permutes its own 32 columns
        assert sorted(order[32 * s:32 * s + 32]) == list(range(32 * s,
                                                               32 * s + 32))
    assert sorted(S.n_order()) == list(range(32))
    # lane (g, t) holds weight rows g, g + 8 of m16 tile u: two
    # neighbouring columns 16u + 2g, 16u + 2g + 1
    nord = S.n_order()
    for u in range(2):
        for g in range(8):
            assert [nord[16 * u + g], nord[16 * u + g + 8]] == \
                [16 * u + 2 * g, 16 * u + 2 * g + 1]


@pytest.mark.parametrize("seed", range(4))
def test_permuted_product_is_exact(seed):
    rng = np.random.default_rng(seed)
    m, n_warps, kt = 16, 3, 3
    a = rng.integers(-128, 128, (m, kt * TILE_K)).astype(np.int64)
    b = rng.integers(-128, 128, (kt * TILE_K, 32 * n_warps)).astype(np.int64)
    kord = np.concatenate([np.array(S.k_order()) + TILE_K * i
                           for i in range(kt)])
    nord = np.concatenate([np.array(S.n_order()) + 32 * w
                           for w in range(n_warps)])
    got = np.empty((m, 32 * n_warps), np.int64)
    got[:, nord] = a[:, kord] @ b[kord][:, nord]
    assert np.array_equal(got, a @ b)
    # the weight enters as 16 w (exact in s8): the sum is 16 x, and its
    # arithmetic shift by 4 is exact
    w = rng.integers(-8, 8, (kt * TILE_K, 32))
    assert np.array_equal((a @ (16 * w)) >> 4, a @ w)


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (sel >> 4n) & 7 of y:x."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _word(buf, off, nbytes=4):
    return int.from_bytes(bytes(buf[off:off + nbytes]), "little")


def _stage(rows, width, off, data):
    """A shared-memory tile: data (rows, width) bytes at off(r, c)."""
    buf = np.zeros(rows * width, np.uint8)
    for r in range(rows):
        for c in range(width):
            buf[off(r, c)] = data[r, c]
    return buf


def _byte(v, i):
    return (v >> (8 * i)) & 0xFF


def test_fragments_follow_k_and_n_order():
    """Every lane's fragments, built from swizzled shared memory the way
    csrc/sparqle_matmul.cu builds them (ldmatrix.trans rows, byte
    permutations, nibble masks), are the k_order() x n_order() gather of
    the unpacked operands: the weight operand (mma A, rows = columns) of
    pack_int4 bytes as 16 w, the activation operand (mma B) of unpacked
    planes and of wire-layout planes."""
    rng = np.random.default_rng(0)
    w = rng.integers(-8, 8, (TILE_K, 64))
    wp = (((w[1::2] & 0xF) << 4) | (w[0::2] & 0xF)).astype(np.uint8)
    q = rng.integers(0, 16, (16, TILE_K))
    qp = (((q[:, 1::2] & 0xF) << 4) | (q[:, 0::2] & 0xF)).astype(np.uint8)
    w_s = _stage(64, 64, S.w_off, wp)
    a_s = _stage(16, 128, S.a_off, q.astype(np.uint8))
    p_s = _stage(16, 64, S.w_off, qp)
    kord, nord = S.k_order(), S.n_order()
    for cg in range(2):
        for s in range(4):
            for g in range(8):
                for t in range(4):
                    # ldmatrix.trans: tile q is rows 16s + 8(q & 1) + 0..7,
                    # bytes cg * 32 + 16(q >> 1) + 0..15; lane (g, t) gets
                    # the 16-bit elements (rows 2t, 2t + 1; column g)
                    r = []
                    for q8 in range(4):
                        row = 16 * s + 8 * (q8 & 1) + 2 * t
                        c = cg * 32 + 16 * (q8 >> 1) + 2 * g
                        r.append(_word(w_s, S.w_off(row, c), 2)
                                 | _word(w_s, S.w_off(row + 1, c), 2) << 16)
                    col = [_byte_perm(r[0], r[1], 0x6420),
                           _byte_perm(r[0], r[1], 0x7531),
                           _byte_perm(r[2], r[3], 0x6420),
                           _byte_perm(r[2], r[3], 0x7531)]
                    for u in range(2):
                        wa = [(col[2 * u] << 4) & 0xF0F0F0F0,
                              (col[2 * u + 1] << 4) & 0xF0F0F0F0,
                              col[2 * u] & 0xF0F0F0F0,
                              col[2 * u + 1] & 0xF0F0F0F0]
                        for reg, (rr, dk) in enumerate(
                                ((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
                            n = cg * 32 + nord[16 * u + rr]
                            for i in range(4):
                                k = kord[32 * s + dk + 4 * t + i]
                                byte = _byte(wa[reg], i)
                                assert byte - 256 * (byte >> 7) == 16 * w[k, n]
                    # A, row g: unpacked 4 + 4 bytes, wire layout 2 + 2
                    u = _word(a_s, S.a_off(g, 32 * s + 4 * t))
                    v = _word(a_s, S.a_off(g, 32 * s + 16 + 4 * t))
                    lo, up = _byte_perm(u, v, 0x6420), _byte_perm(u, v, 0x7531)
                    pv = _byte_perm(_word(p_s, S.w_off(g, 16 * s + 2 * t), 2),
                                    _word(p_s, S.w_off(g, 16 * s + 8 + 2 * t),
                                          2), 0x5410)
                    for i in range(4):
                        k0 = 32 * s + 4 * t + i
                        assert _byte(lo, i) == q[g, kord[k0]]
                        assert _byte(up, i) == q[g, kord[k0 + 16]]
                        assert _byte(pv & 0x0F0F0F0F, i) == q[g, kord[k0]]
                        assert _byte((pv >> 4) & 0x0F0F0F0F, i) == \
                            q[g, kord[k0 + 16]]


def test_swizzles_are_bijections():
    w = sorted(S.w_off(r, c) for r in range(64) for c in range(64))
    a = sorted(S.a_off(r, c) for r in range(64) for c in range(128))
    assert w == list(range(64 * 64))
    assert a == list(range(64 * 128))
    # a 16 B chunk stays whole (cp.async and ldmatrix move chunks)
    for off, cols in ((S.w_off, 64), (S.a_off, 128)):
        for r in range(64):
            for c in range(0, cols, 16):
                base = off(r, c)
                assert base % 16 == 0
                assert [off(r, c + b) for b in range(16)] == \
                    list(range(base, base + 16))


def _banks(offsets):
    return [(o // 4) % 32 for o in offsets]


@pytest.mark.parametrize("cg", [0, 1])
def test_fragment_reads_are_bank_conflict_free(cg):
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for s in range(4):
        # ldmatrix: each tile's 8 rows of 16 B fill the 32 banks
        for q8 in range(4):
            rows = [16 * s + 8 * (q8 & 1) + rr for rr in range(8)]
            c = cg * 32 + 16 * (q8 >> 1)
            banks = [b for r in rows
                     for b in _banks(S.w_off(r, c) + 4 * i for i in range(4))]
            assert len(set(banks)) == 32
        for mt in range(4):
            for h in range(2):
                rows = [mt * TILE_M + 8 * h + g for g, _ in lanes]
                # unpacked: one 32-bit word a lane, twice
                for base in (32 * s, 32 * s + 16):
                    banks = _banks(S.a_off(r, base + 4 * t)
                                   for r, (_, t) in zip(rows, lanes))
                    assert len(set(banks)) == 32
                # wire layout: 16-bit halves, lanes 2u and 2u + 1 share a
                # word (a broadcast); distinct words in distinct banks
                for base in (16 * s, 16 * s + 8):
                    words = {S.w_off(r, base + 2 * t) // 4
                             for r, (_, t) in zip(rows, lanes)}
                    assert len({wd % 32 for wd in words}) == len(words) == 16


def test_register_unpack_selectors():
    """The remaining byte and nibble arithmetic of csrc/sparqle_matmul.cu
    on random words: the packed A halves' join, and the MSB operand."""
    rng = np.random.default_rng(1)
    for _ in range(50):
        h0, h1 = (int(v) for v in rng.integers(0, 2 ** 16, 2))
        v = _byte_perm(h0, h1, 0x5410)
        assert v == h0 | (h1 << 16)
    # the MSB operand 16 * msb4 is exact in s8 for every msb4 in [-8, 7],
    # from an int8 container byte and from a wire nibble alike
    for v in range(-8, 8):
        assert ((v & 0xFF) << 4) & 0xF0 == (16 * v) & 0xFF
        assert ((v & 0xF) << 4) & 0xF0 == (16 * v) & 0xFF


def test_int32_accumulator_holds_16x_the_sum_up_to_max_k():
    # per k: |lsb4 * 16w| + |16 msb4 * 16w| <= 16 * (15 + 128) * 8
    assert 16 * (15 + 128) * 8 * S.MAX_K < 2 ** 31


# ---------------------------------------------------------------------------
# the dense entry (quant_matmul_launch): the same body on a full-range q
# ---------------------------------------------------------------------------

def _kernel_acc(q, w, per):
    """csrc/sparqle_matmul.cu's int32 arithmetic on a full-range int8 q
    (M, K) and int4 w (K, N): the weight operand 16 w; in every split of
    ``per`` K tiles, K half kh sums k32 steps 2kh, 2kh + 1 of each tile
    in a wrapping int32 accumulator (mma.sync s32 does not saturate); the
    halves meet as (a + b) >> 4 in int32; the splits' partials sum in
    int32. int32 sums wrap mod 2^32 in any order, so each sum is taken
    exactly in int64 and wrapped once."""
    def wrap(x):
        return np.asarray(x, np.int64).astype(np.int32)
    k = q.shape[1]
    kk = np.arange(k)
    half = (kk % TILE_K) // 64
    tile = kk // TILE_K
    q64, w16 = q.astype(np.int64), 16 * w.astype(np.int64)
    total = np.zeros((q.shape[0], w.shape[1]), np.int32)
    for lo in range(0, -(-k // TILE_K), per):
        split = (tile >= lo) & (tile < lo + per)
        a, b = (wrap(q64[:, split & (half == h)] @ w16[split & (half == h)])
                for h in (0, 1))
        meet = wrap(a.astype(np.int64) + b) >> 4
        total = wrap(total.astype(np.int64) + meet)
    return total


@pytest.mark.parametrize("seed", range(3))
def test_dense_int32_model_equals_the_product(seed):
    rng = np.random.default_rng(seed)
    m, k, n = 5, 1000, 24
    q = rng.integers(-128, 128, (m, k))
    w = rng.integers(-8, 8, (k, n))
    for per in (1, 2, 3, 8):
        assert np.array_equal(_kernel_acc(q, w, per), q @ w)


@pytest.mark.parametrize("m", [1, 8, 32, 1024])
def test_dense_int32_exact_at_max_k_extreme_operands(m):
    # q = -128, w = -8: every term is +2^14 (the largest), at K = MAX_K
    # under the split the wrapper launches and under one split
    k, n = S.MAX_K, 14336
    q = np.full((1, k), -128)
    w = np.full((k, 1), -8)
    for per in (S.launch_plan(m, n, k).per, k // TILE_K):
        assert _kernel_acc(q, w, per)[0, 0] == 1024 * k


def test_dense_int32_first_overflows_at_k_131072():
    # one split (a wide grid needs no split): all of K in one block
    for k, exact in ((131071, True), (131072, False)):
        q = np.full((1, k), -128)
        w = np.full((k, 1), -8)
        got = _kernel_acc(q, w, -(-k // TILE_K))[0, 0]
        assert (got == 1024 * k) == exact
    assert 128 * 128 * 131071 < 2 ** 31 <= 128 * 128 * 131072
    assert S.MAX_K < 131072


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper's
    kernel branch runs here and its launch can be recorded."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def dense_launches(monkeypatch):
    """quant_matmul's kernel branch on the CPU: the launch recorded, the
    device's counter buffer a CPU one."""
    calls = []
    monkeypatch.setattr(QM.KERNEL, "launch", lambda *a: calls.append(a))
    monkeypatch.setitem(S._COUNTERS, torch.device("cpu"),
                        torch.zeros(S.TARGET_BLOCKS, dtype=torch.int32))

    def run(m, n, k, acc_out=False):
        q = torch.Tensor._make_subclass(
            _OnCard, torch.empty((m, k), dtype=torch.int8))
        res = QM.quant_matmul(q, torch.empty((k // 2, n), dtype=torch.int8),
                              torch.empty((m, 1)), torch.empty((1, n)),
                              acc_out=acc_out)
        return res, calls
    return run


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_dense_launch_covers_every_tile_once(dense_launches, m, n, k):
    """The dense wrapper launches the shared body once, with a K split
    whose grid (as the C entry derives it from ``per``) computes every
    (m16, column, K tile) exactly once, a workspace pointer where it
    splits and the device's counters."""
    res, calls = dense_launches(m, n, k, acc_out=k % 3 == 0)
    assert len(calls) == 1
    (q_ptr, w_ptr, _, _, out, acc, ws, counters, mm, nn, kk,
     per) = calls[0]
    assert (mm, nn, kk) == (m, n, k)
    assert (acc if k % 3 == 0 else out) == res.data_ptr()
    assert (out if k % 3 == 0 else acc) is None
    n_kt = -(-k // TILE_K)
    plan = S.Plan(-(-n // S.BLOCK_N), -(-m // S.BLOCK_M), n_kt, per,
                  -(-n_kt // per))
    assert plan == S.launch_plan(m, n, k)
    assert (ws is not None) == (plan.splits > 1)
    assert counters == S._COUNTERS[torch.device("cpu")].data_ptr()
    count = np.zeros((-(-m // TILE_M), n, n_kt), np.int32)
    for bx, by, bz in _blocks(plan):
        for mt, lo, hi, kt in S.block_tiles(plan, m, n, bx, by, bz):
            count[mt, lo:hi, kt] += 1
    assert (count == 1).all()


def test_dense_wrapper_raises_above_max_k(dense_launches):
    dense_launches(1, 8, S.MAX_K)
    with pytest.raises(ValueError, match="int32 accumulator"):
        dense_launches(1, 8, S.MAX_K + 2)

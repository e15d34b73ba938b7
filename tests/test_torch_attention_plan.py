"""The split-KV attention plan and the fused encoder's plan, on the CPU.

``csrc/kv_attention.cu`` and the fused entries of
``csrc/sparqle_encode.cu`` cannot run here, so their launch plans have
plain-Python mirrors (``kernels.kv_attention.split_plan``,
``kernels.sparqle_encode.fused_plan``) and their arithmetic order a
torch emulation below. These tests hold the mirrors to what the kernels
need: every page read by exactly one warp of one cluster rank (in tiles
of 16 token rows, for pages of any size), a plan that depends on the
table width alone (so decode, verify, tiered and
contiguous calls split alike), a split-and-merge that stays within 1e-5
of the plain attention and gives a verify window the bits of T decode
calls, a chunk past ``pos`` that changes no bit whether merged or
skipped; every (row, 8-column chunk) of a row group encoded by one lane
of one block, each K tile counted by one block, a block's registers,
threads, shared memory and cluster within the card's, the plan a
function of the shapes alone; and the fused scale's formula (the kernel's
``token_scale``) bit-equal to ``activation_scale(x).float()`` and to
JAX's ``quantize_activations`` scale, zero and tiny rows included.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_activations as jquant_act
from repro_torch.core.quantize import activation_scale
from repro_torch.kernels import kv_attention as A
from repro_torch.kernels import ref
from repro_torch.kernels import sparqle_encode as E
from repro_torch.kernels.ref import TILE_K, TILE_M

WIDTHS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64, 100, 128, 255,
          256, 257, 1024]


# ---------------------------------------------------------------------------
# the attention split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_s", WIDTHS)
def test_split_plan_reads_every_page_once(n_s):
    plan = A.split_plan(n_s)
    assert 1 <= plan.cluster <= A.MAX_CLUSTER
    assert plan.pages_per_block == A.WARPS * plan.pages_per_warp
    # no rank is empty: the last one starts inside the table
    assert (plan.cluster - 1) * plan.pages_per_block < n_s
    seen = {}
    for i in range(n_s):
        rank, warp = A.page_owner(plan, i)
        assert 0 <= rank < plan.cluster and 0 <= warp < A.WARPS
        seen.setdefault((rank, warp), []).append(i)
    for pages in seen.values():   # a warp's pages are consecutive
        assert pages == list(range(pages[0], pages[0] + len(pages)))
        assert len(pages) <= plan.pages_per_warp


def test_small_tables_give_each_warp_one_page():
    """Up to WARPS * MAX_CLUSTER pages, a page's owner does not depend on
    the table width: a contiguous cache of 4 blocks and an engine table
    of 9 pages split the same pages alike."""
    for n_s in range(1, A.WARPS * A.MAX_CLUSTER + 1):
        plan = A.split_plan(n_s)
        assert plan.pages_per_warp == 1
        for i in range(n_s):
            assert A.page_owner(plan, i) == (i // A.WARPS, i % A.WARPS)


def test_split_plan_is_a_function_of_the_width_alone():
    assert list(inspect.signature(A.split_plan).parameters) == ["n_s"]
    assert A.split_plan(256) == (8, 32, 8)
    assert A.split_plan(16) == (1, 4, 4)
    with pytest.raises(ValueError):
        A.split_plan(0)


# ---------------------------------------------------------------------------
# a torch emulation of the kernel's split and fixed-order merge
# ---------------------------------------------------------------------------

def _merge(a, b):
    (ma, la, aa), (mb, lb, ab) = a, b
    mn = torch.maximum(ma, mb)
    ca, cb = torch.exp(ma - mn), torch.exp(mb - mn)
    return mn, la * ca + lb * cb, aa * ca[..., None] + ab * cb[..., None]


def _fold(states, skip_empty):
    """States (live, m, l, acc) merged in list order; an empty state is
    skipped or merged, as ``skip_empty`` says."""
    live0, *acc = states[0]
    out = tuple(acc)
    for live, *st in states[1:]:
        if live or not skip_empty:
            out = _merge(out, tuple(st))
    return live0, out


def emulate(q, kd, vd, tables, pos, skip_empty=True, window=0):
    """Split-KV decode as the kernel splits it: q (B, KVH, G, hd) f32 over
    dequantized pages kd/vd (P, ps, KVH, hd) through tables (B, NS), each
    page in tiles of TILE_ROWS tokens (the kernel's rows past the page's
    end are masked: -2e38 to the max, exact zeros to the sums). With a
    sliding ``window`` (the contiguous kernel's): the pages from lo =
    max(0, pos - window + 1) // ps are the plan's pages 0.., split by the
    window span's plan when lo > 0 (else by the table width's), keys
    below pos - window + 1 are masked and their p set to 0."""
    b, kvh, g, hd = q.shape
    ps, n_s = kd.shape[1], tables.shape[1]
    scale = hd ** -0.5
    out = torch.empty_like(q)
    for bi in range(b):
        p = int(pos[bi])
        last = min(max(p, 0) // ps, n_s - 1)
        start = p - window + 1 if window else 0
        lo = min(max(start, 0) // ps, last) if window else 0
        last_v = last - lo
        plan = A.split_plan(A.window_span(n_s, ps, window) if lo else n_s)
        blocks = []
        for rank in range(plan.cluster):
            warps = []
            for w in range(A.WARPS):
                first = rank * plan.pages_per_block + w * plan.pages_per_warp
                m = torch.full((kvh, g), ref.NEG_INF)
                lsum = torch.zeros((kvh, g))
                acc = torch.zeros((kvh, g, hd))
                wlast = min(first + plan.pages_per_warp - 1, last_v)
                for step in range(first, wlast + 1):
                    page = int(tables[bi, lo + step])
                    for r0 in range(0, ps, A.TILE_ROWS):
                        rows = slice(r0, min(ps, r0 + A.TILE_ROWS))
                        # (KVH, 1, rows, hd)
                        k = kd[page, rows].permute(1, 0, 2)[:, None]
                        v = vd[page, rows].permute(1, 0, 2)[:, None]
                        s = (q[bi][:, :, None, :] * k).sum(-1) * scale
                        tok = ((lo + step) * ps + r0
                               + torch.arange(k.shape[2]))
                        live = (tok <= p) & (tok >= start)
                        s = torch.where(live, s, ref.NEG_INF)
                        mn = torch.maximum(m, s.amax(-1))
                        corr = torch.exp(m - mn)
                        pr = torch.exp(s - mn[..., None])
                        if window:
                            pr = torch.where(live, pr, 0.0)
                        lsum = lsum * corr + pr.sum(-1)
                        acc = (acc * corr[..., None]
                               + (pr[..., None] * v).sum(-2))
                        m = mn
                warps.append((first <= last_v, m, lsum, acc))
            live, st = _fold(warps, skip_empty)
            blocks.append((live, *st))
        _, (m, lsum, acc) = _fold(blocks, skip_empty)
        out[bi] = acc / torch.clamp_min(lsum, 1e-30)[..., None]
    return out


def _pool(seed, n_pages, ps, kvh, hd):
    g = torch.Generator().manual_seed(seed)
    kp, vp = (torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                            generator=g, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, kvh), generator=g) * 0.2
              for _ in range(2))
    return kp, ks, vp, vs


def _deq(pages, scales):
    return ref.unpack_kv4(pages).float() * scales[..., None]


@pytest.mark.parametrize("n_s", [3, 16, 40, 70])
def test_emulated_split_matches_plain_attention(n_s):
    b, kvh, g, hd, ps = 5, 2, 4, 16, 4
    kp, ks, vp, vs = _pool(n_s, 1 + b * n_s, ps, kvh, hd)
    gen = torch.Generator().manual_seed(n_s + 1)
    tables = (torch.randperm(b * n_s, generator=gen) + 1).reshape(
        b, n_s).to(torch.int32)
    tables[-1] = 0                                   # inactive slot
    pos = torch.tensor([0, ps - 1, ps * n_s // 2 + 1, n_s * ps - 1, 0],
                       dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd), generator=gen)
    want = ref.kv4_paged_decode_attention_ref(q, kp, ks, vp, vs, tables, pos)
    got = emulate(q, _deq(kp, ks), _deq(vp, vs), tables, pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ps,g", [(5, 3), (40, 2), (16, 6)])
def test_emulated_tiles_match_plain_attention(ps, g):
    """Pages of any size in tiles of 16 rows (the last one short), and a
    group of G query heads that is no multiple of 4."""
    b, kvh, hd, n_s = 4, 2, 16, 9
    kp, ks, vp, vs = _pool(ps + g, 1 + b * n_s, ps, kvh, hd)
    gen = torch.Generator().manual_seed(ps * g)
    tables = (torch.randperm(b * n_s, generator=gen) + 1).reshape(
        b, n_s).to(torch.int32)
    pos = torch.tensor([0, ps + 3, ps * n_s // 2, n_s * ps - 1],
                       dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd), generator=gen)
    want = ref.kv4_paged_decode_attention_ref(q, kp, ks, vp, vs, tables, pos)
    got = emulate(q, _deq(kp, ks), _deq(vp, vs), tables, pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_emulated_verify_window_gives_decode_bits():
    """A verify window is the decode kernel launched with T tokens a
    sequence: token t is a decode query at pos + t over the same table
    width, hence the same split, hence the same bits."""
    b, t, kvh, g, hd, ps, n_s = 3, 3, 2, 4, 16, 4, 40
    kp, ks, vp, vs = _pool(7, 1 + b * n_s, ps, kvh, hd)
    kd, vd = _deq(kp, ks), _deq(vp, vs)
    gen = torch.Generator().manual_seed(8)
    tables = (torch.randperm(b * n_s, generator=gen) + 1).reshape(
        b, n_s).to(torch.int32)
    pos = torch.tensor([2, 4 * ps - 2, n_s * ps - t], dtype=torch.int32)
    q = torch.randn((b, t, kvh, g, hd), generator=gen)
    window = emulate(q.reshape(b * t, kvh, g, hd), kd, vd,
                     tables.repeat_interleave(t, 0),
                     (pos[:, None] + torch.arange(t)).reshape(-1))
    for i in range(t):
        single = emulate(q[:, i], kd, vd, tables, pos + i)
        assert torch.equal(window.reshape(b, t, kvh, g, hd)[:, i], single)


def test_chunks_past_pos_change_no_bit():
    """A warp or cluster rank whose first page lies past pos merges an
    empty state (m = -2e38, l = 0, acc = 0): exp(-2e38 - m) = 0 and
    exp(0) = 1 leave every bit as if it had not been launched."""
    b, kvh, g, hd, ps, n_s = 4, 2, 4, 16, 4, 70
    kp, ks, vp, vs = _pool(9, 1 + b * n_s, ps, kvh, hd)
    kd, vd = _deq(kp, ks), _deq(vp, vs)
    gen = torch.Generator().manual_seed(10)
    tables = (torch.randperm(b * n_s, generator=gen) + 1).reshape(
        b, n_s).to(torch.int32)
    pos = torch.tensor([0, 9, 130, 200], dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd), generator=gen)
    assert torch.equal(emulate(q, kd, vd, tables, pos, skip_empty=True),
                       emulate(q, kd, vd, tables, pos, skip_empty=False))


def test_emulated_contiguous_equals_paged_tiling():
    """The contiguous cache read with the implicit table b * NS + i and
    the same cache cut into shuffled pages: the same split, the same
    bits."""
    b, s, kvh, g, hd, ps = 3, 48, 2, 4, 16, 4
    n_s = s // ps
    kp, ks, vp, vs = _pool(11, b * n_s, ps, kvh, hd)
    kd, vd = _deq(kp, ks), _deq(vp, vs)
    implicit = torch.arange(b * n_s, dtype=torch.int32).reshape(b, n_s)
    perm = torch.randperm(b * n_s, generator=torch.Generator().manual_seed(12))
    inv = torch.argsort(perm)
    shuffled = inv[implicit.long()].to(torch.int32)
    pos = torch.tensor([0, 17, s - 1], dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd),
                    generator=torch.Generator().manual_seed(13))
    assert torch.equal(emulate(q, kd, vd, implicit, pos),
                       emulate(q, kd[perm], vd[perm], shuffled, pos))


def _contiguous(seed, b, n_s, ps, kvh, hd):
    """A contiguous cache of b sequences x n_s blocks of ps tokens as
    pages with the kernel's implicit table b * NS + i, and its packed
    (B, S, ...) form for the plain version."""
    kp, ks, vp, vs = _pool(seed, b * n_s, ps, kvh, hd)
    implicit = torch.arange(b * n_s, dtype=torch.int32).reshape(b, n_s)
    packed = tuple(x.reshape(b, n_s * ps, *x.shape[2:])
                   for x in (kp, ks, vp, vs))
    return _deq(kp, ks), _deq(vp, vs), implicit, packed


@pytest.mark.parametrize("window", [1, 3, 4, 5, 7, 13, 40, 1000])
@pytest.mark.parametrize("ps,n_s", [(4, 40), (16, 9), (40, 5)])
def test_emulated_window_matches_plain_attention(window, ps, n_s):
    """The windowed contiguous decode as the kernel splits it: windows of
    1, of a block +- 1, not a multiple of one, starting mid-block (and,
    with blocks of 40 = three tiles, a tile wholly below the start read
    first); within 1e-5 of the plain version at each pos."""
    b, kvh, g, hd = 4, 2, 3, 16
    kd, vd, implicit, packed = _contiguous(window + ps, b, n_s, ps, kvh, hd)
    s = n_s * ps
    pos = torch.tensor([0, ps + 1, s // 2 + 3, s - 1], dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd),
                    generator=torch.Generator().manual_seed(window))
    want = ref.kv4_decode_attention_ref(q, *packed, pos, window=window)
    got = emulate(q, kd, vd, implicit, pos, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_s", [9, 70, 129])
def test_emulated_window_that_does_not_bind_gives_window0_bits(n_s):
    """window >= pos + 1: lo = 0 and no key masked, so the plan is the
    table width's as at window 0 and the bits are window 0's, also where
    a warp reads several pages (NS 70, 129: 3 and 5 a warp)."""
    b, kvh, g, hd, ps = 3, 2, 2, 16, 4
    kd, vd, implicit, _ = _contiguous(n_s, b, n_s, ps, kvh, hd)
    pos = torch.tensor([5, n_s * ps // 2, n_s * ps - 1], dtype=torch.int32)
    q = torch.randn((b, kvh, g, hd), generator=torch.Generator().manual_seed(1))
    plain = emulate(q, kd, vd, implicit, pos)
    for window in (n_s * ps, n_s * ps + 7):
        assert torch.equal(emulate(q, kd, vd, implicit, pos, window=window),
                           plain)
    # a window of pos + 1 for each sequence alone
    for bi in range(b):
        w = int(pos[bi]) + 1
        assert torch.equal(emulate(q[bi:bi + 1], kd, vd, implicit[bi:bi + 1],
                                   pos[bi:bi + 1], window=w), plain[bi:bi + 1])


@pytest.mark.parametrize("n_s,ps,window", [(129, 16, 1024), (129, 16, 1000),
                                           (33, 16, 500), (256, 16, 17),
                                           (40, 40, 1000)])
def test_window_span_plan_covers_every_live_block(n_s, ps, window):
    """A window past block 0 touches at most ``window_span`` blocks, and
    their plan's cluster fits the launch's (the larger of the two
    plans'); gemma3-27b's 2,064-position cache with its window of 1,024
    splits 65 blocks 3 a warp where the table's plan takes 5."""
    span = A.window_span(n_s, ps, window)
    launch = max(A.split_plan(n_s).cluster, A.split_plan(span).cluster)
    assert launch <= A.MAX_CLUSTER
    for p in range(window, n_s * ps):
        lo, last = (p - window + 1) // ps, p // ps
        assert last - lo + 1 <= span
        plan = A.split_plan(span)
        assert A.page_owner(plan, last - lo)[0] < plan.cluster <= launch
    if (n_s, window) == (129, 1024):
        assert (span, A.split_plan(span).pages_per_warp,
                A.split_plan(n_s).pages_per_warp) == (65, 3, 5)


# ---------------------------------------------------------------------------
# the encoder's plan
# ---------------------------------------------------------------------------

PLAN_M = [1, 4, 8, 16, 17, 32, 1024]
PLAN_K = [128, 200, 2048, 4096, 4100, 14336, 21504]
# (scale_in, x_bf16): the fused entries in both dtypes, the scale-taking
# ones
PLAN_KINDS = [(False, True), (False, False), (True, True)]


def plan_owners(plan, m, k):
    """Every (row, chunk of 8 columns) of row group 0 that the kernel's
    lanes encode, as the kernel maps them: block b of the group, row r,
    warp w, lane l, pass p, slot j encode chunk ((p J + j) W + w) 32 + l
    of the block's tiles, if it lies inside them and inside the plane.
    Returns {(row, chunk): [owners]}."""
    n_kt = -(-k // TILE_K)
    n_ch = -(-k // E.CHUNK)
    owners = {}
    slots = np.arange(plan.passes * plan.chunks * plan.warps * 32)
    for b in range(plan.blocks):
        t0, t1 = b * plan.tiles, min((b + 1) * plan.tiles, n_kt)
        local = slots[(slots < (t1 - t0) * E.TILE_CHUNKS)
                      & (t0 * E.TILE_CHUNKS + slots < n_ch)]
        # slot = ((p J + j) W + w) 32 + lane
        lane, w = local % 32, (local // 32) % plan.warps
        pj = local // (32 * plan.warps)
        for r in range(min(m, TILE_M)):
            for c, ww, ll, q in zip(t0 * E.TILE_CHUNKS + local, w, lane,
                                    pj):
                owners.setdefault((r, int(c)), []).append(
                    (b, int(ww), int(ll), int(q)))
    return owners


@pytest.mark.parametrize("scale_in,bf16", PLAN_KINDS)
@pytest.mark.parametrize("k", PLAN_K)
@pytest.mark.parametrize("m", PLAN_M)
def test_fused_plan_covers_every_tile_once(m, k, scale_in, bf16):
    """Every (row, chunk) of a row group is encoded by exactly one lane
    of one block, each TILE_K tile by one block (whose count is then
    stored once), and the block's rows hold the group's rows."""
    plan = E.fused_plan(m, k, scale_in=scale_in, bf16=bf16)
    n_kt = -(-k // TILE_K)
    assert (plan.blocks - 1) * plan.tiles < n_kt <= plan.blocks * plan.tiles
    assert plan.rows >= min(m, TILE_M) and plan.rows & (plan.rows - 1) == 0
    assert plan.rows <= TILE_M and (m >= TILE_M or plan.rows < 2 * m)
    owners = plan_owners(plan, m, k)
    n_ch = -(-k // E.CHUNK)
    assert set(owners) == {(r, c) for r in range(min(m, TILE_M))
                           for c in range(n_ch)}
    assert all(len(o) == 1 for o in owners.values())
    tile_blocks = {}
    for (r, c), [(b, _, _, _)] in owners.items():
        tile_blocks.setdefault(c // E.TILE_CHUNKS, set()).add(b)
    assert all(len(bs) == 1 for bs in tile_blocks.values())
    # a tile is half a warp's chunks in one (pass, slot): its count is
    # summed by shuffles inside the half warp
    for (r, c), [(b, w, lane, q)] in owners.items():
        base = c - b * plan.tiles * E.TILE_CHUNKS - lane
        assert base % 32 == 0 and (base + (lane & 16)) // 16 == \
            (c - b * plan.tiles * E.TILE_CHUNKS) // 16


@pytest.mark.parametrize("k", PLAN_K)
@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("bf16", [True, False])
def test_fused_plan_fits_shared_memory(m, k, bf16):
    """A block's threads, a lane's registers (64 B of x a pass) and its
    shared memory fit; the cluster of a row group is at most 16 blocks;
    a block holds the fewest warps that give a lane its chunks."""
    plan = E.fused_plan(m, k, bf16=bf16)
    jmax = E.LANE_CHUNKS[bf16]
    assert plan.threads <= E.MAX_THREADS and plan.threads % 32 == 0
    assert 1 <= plan.chunks <= jmax
    assert plan.passes * plan.chunks * plan.warps * 32 >= \
        plan.tiles * E.TILE_CHUNKS
    assert plan.blocks <= E.MAX_CLUSTER
    assert plan.smem(bf16) <= E.MAX_SMEM
    if plan.passes == 1:   # x in registers
        assert plan.smem(bf16) == 0
    if (m, k) in ((8, 4096), (1, 4096), (8, 14336)):
        # decode: a cluster of 16 blocks over K, no warp past M
        assert (plan.blocks, plan.rows, plan.passes) == (16, m, 1)


def test_fused_plan_limit_is_above_the_zoo():
    """The fused entries take a row of at most 112 KB: the widest
    projection input of the zoo (gemma3-27b d_ff) in f32, every width
    they took before (55,296 bf16, 27,648 f32) and up to 57,344 bf16 /
    28,672 f32; 65,536 bf16 is refused before any launch."""
    assert E.fused_k_fits(21504, False)
    for k, bf16 in ((55296, True), (27648, False), (57344, True),
                    (28672, False)):
        assert E.fused_k_fits(k, bf16)
        for m in PLAN_M:
            assert E.fused_plan(m, k, bf16=bf16).smem(bf16) <= E.MAX_SMEM
    assert not E.fused_k_fits(65536, True)
    assert not E.fused_k_fits(28680, False)
    x = torch.empty((8, 65536), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="K=65536"):
        E.sparqle_encode_fused(x)


@pytest.mark.parametrize("k", [200, 4096, 14336, 65536, 1 << 20])
def test_scale_in_plan_takes_any_width(k):
    """The entries that take a scale need no amax, so K is split over as
    many blocks as it needs, no cluster: any K in one pass, in the
    default 48 KB of shared memory, every tile counted by one block."""
    for m in (1, 8, 1024):
        plan = E.fused_plan(m, k, scale_in=True)
        n_kt = -(-k // TILE_K)
        assert plan.passes == 1 and plan.smem(True) <= 48 * 1024
        assert (plan.blocks - 1) * plan.tiles < n_kt
        assert plan.blocks * plan.tiles >= n_kt
        assert plan.chunks * plan.warps * 32 >= plan.tiles * E.TILE_CHUNKS


@pytest.mark.parametrize("m,k,e,blocks", [
    (8, 4096, 1, 16), (1, 4096, 1, 16), (32, 4096, 1, 32),
    (1024, 4096, 1, 256), (1, 2048, 64, 64), (1, 7168, 256, 256),
    (3, 2048, 64, 64)])
def test_fused_plan_fills_the_card(m, k, e, blocks):
    """Decode splits K over a cluster of 16 blocks; a routed projection at
    small C is one block an expert (64 at E = 64, 256 at E = 256: one
    wave of two blocks an SM); the --legacy prefill keeps ~2 blocks an
    SM."""
    plan = E.fused_plan(m, k, e)
    assert plan.blocks * -(-m // TILE_M) * e == blocks
    if e > 1 and m < TILE_M:
        assert plan.blocks == 1 and plan.rows == _pow2(m)


def _pow2(n):
    return 1 << (n - 1).bit_length()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper's
    kernel branch runs here and its launch can be recorded."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("entry", ["sparqle_encode", "sparqle_quantize",
                                   "sparqle_encode_packed"])
def test_plan_reads_only_shapes(monkeypatch, entry, fused):
    """The launch of a batched call is the same whatever the live rows
    hold (a CUDA graph freezes grid and block): only the rows pointer
    differs, and the plan's five ints are those of the shapes."""
    calls = []
    for k in E.__dict__.values():
        if isinstance(k, E._build.Kernel):
            monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
                (k.name, a)))
    e, c, kk = 64, 3, 2048
    x = torch.Tensor._make_subclass(_OnCard, torch.zeros(
        (e, c, kk), dtype=torch.bfloat16))
    mask = torch.zeros((e, kk), dtype=torch.bool)
    scale = torch.ones((e, c, 1))
    fn = getattr(E, entry + ("_fused" if fused else ""))
    for n in (0, 1, 3):
        rows = torch.full((e,), n, dtype=torch.int32)
        if fused:
            fn(x, mask, -8, 23, rows=rows)
        else:
            fn(x, scale, mask, -8, 23, rows=rows)
    assert len(calls) == 3 and len({name for name, _ in calls}) == 1
    assert calls[0][0] == entry + ("_fused" if fused else "") + "_batched"
    heads = {a[:-1] for _, a in calls}
    # the pointers of the outputs differ call to call: compare the ints
    ints = {tuple(v for v in h if isinstance(v, int) and v < 1 << 20)
            for h in heads}
    assert len(ints) == 1
    plan = E.fused_plan(c, kk, e, scale_in=not fused).args()
    assert calls[0][1][-7:-2] == plan and calls[0][1][-2] == e


# ---------------------------------------------------------------------------
# the fused scale
# ---------------------------------------------------------------------------

def token_scale(amax: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The kernel's ``token_scale`` in torch: the f32 quotient amax / 127
    (``__fdiv_rn``), rounded to bf16 for a bf16 x, clamped below at 1e-8
    in x's dtype, as f32."""
    v = amax.float() / 127.0
    lo = torch.tensor(1e-8, dtype=torch.float32)
    if bf16:
        v = v.to(torch.bfloat16).float()
        lo = lo.to(torch.bfloat16).float()
    return torch.where(v < lo, lo, v)


def _rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 300)) * rng.uniform(0.01, 30, (12, 1))
    x[0] = 0.0                             # all-zero row
    x[1] = rng.standard_normal(300) * 1e-8  # amax / 127 below 1e-8
    x[2] = 1e-30                           # far below, denormal quotient
    x[3, :] = 0.0
    x[3, 7] = -127e-8                      # amax / 127 right at 1e-8
    x[4] *= 1e6
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_scale_equals_activation_scale_and_jax(dtype):
    x = _rows()
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = np.asarray(jquant_act(xj).scale)
    mirror = token_scale(xt.float().abs().amax(-1, keepdim=True),
                         dtype == "bfloat16")
    fused = E.sparqle_encode_fused(xt)[-1]
    assert fused.dtype == torch.float32 and fused.shape == (12, 1)
    np.testing.assert_array_equal(fused.numpy(), want)
    assert torch.equal(fused, activation_scale(xt).float())
    assert torch.equal(mirror, fused)
    assert torch.equal(E.sparqle_quantize_fused(xt)[1], fused)
    assert torch.equal(E.sparqle_encode_packed_fused(xt)[-1], fused)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_plain_versions_equal_unfused_on_their_scale(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((9, 260)) * 5).astype(
        np.float32)).to(dtype)
    x[0] = 0
    mask = torch.from_numpy(rng.random(260) < 0.5)
    *planes, scale = E.sparqle_encode_fused(x, mask, -8, 23)
    for a, b in zip(planes, E.sparqle_encode(x, scale, mask, -8, 23)):
        assert torch.equal(a, b)
    q, s2 = E.sparqle_quantize_fused(x, mask, -8, 23)
    assert torch.equal(s2, scale)
    assert torch.equal(q, E.sparqle_quantize(x, scale, mask, -8, 23))
    *packed, s3 = E.sparqle_encode_packed_fused(x, mask, -8, 23)
    assert torch.equal(s3, scale)
    for a, b in zip(packed, E.sparqle_encode_packed(x, scale, mask, -8, 23)):
        assert torch.equal(a, b)
    lsb, msb, pbm, pop, _ = E.sparqle_encode_fused(x, mask, -8, 23,
                                                   with_pbm=False)
    assert pbm is None and torch.equal(lsb, planes[0])
    assert pop.shape == (-(-9 // TILE_M), -(-260 // TILE_K))


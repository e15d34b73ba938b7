"""The live rows of a routed projection (``rows``): the expert-batched
encoder and matmul entries take each expert's filled row count and treat
the rows at and past it as zero; ``models/moe.py`` ``moe_ffn`` forms that
count from its dispatch and hands it to the three routed projections.

On the CPU every entry runs its plain version (``kernels/ref.py``
``batched`` with ``rows``), whose contract these tests hold:

* (a) each batched entry with ``rows`` equals the 2-D plain version, one
  expert at a time, on operands whose rows past the count are zeroed by
  the test itself, bit for bit, over E in {1, 8}, C in {1, 3, 17} and
  four patterns of counts, with garbage (NaN and huge values in x,
  random bytes in the planes) past the count; the custom op's CPU kernel
  agrees, its fake gives the shapes;
* (b) ``moe_ffn``'s count is the number of filled capacity slots of each
  expert (assignments dropped past capacity, C > 1, and a mesh rank's
  ``expert_lo`` slice of the experts);
* (c) ``moe_ffn`` with the count equals ``moe_ffn`` without it bit for
  bit and JAX's ``repro.models.moe.moe_ffn`` on the same numpy inputs,
  at f32 within ``tests/test_torch_moe.py``'s tolerance (rtol 4e-6,
  atol 1e-6), at bf16 bit for bit;
* (d) the MoE decode steps traced by ``make_fx`` keep the count on the
  device: ``repro_torch.analysis`` finds no host read, and the batched
  kernels' ops take it as a traced tensor.

The kernels' own bits against these plain versions are held on the card
(``chip_smoke.py`` phase 3, ``check_expert_rows``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.packing import pack_nibbles, pad_k
from repro_torch.core.qlinear import pack_int4
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ref
from repro_torch.kernels import sparqle_encode as SE
from repro_torch.kernels import sparqle_matmul as SM
from repro_torch.models import moe as tmoe

K, N = 200, 40          # ragged: K mod 128 = 72, N mod 64 = 40
PATTERNS = ("empty", "full", "partial", "random")


def counts(e: int, c: int, pattern: str, seed: int) -> torch.Tensor:
    """(E,) int32 live rows: none, all C, a count cutting a row tile
    (16-row groups and 8-row mma tiles) for every expert, or seeded
    random counts in [0, C] with expert 0 empty."""
    if pattern == "empty":
        r = [0] * e
    elif pattern == "full":
        r = [c] * e
    elif pattern == "partial":
        r = [max(1, c - 1 - i % 3) if c > 1 else 1 for i in range(e)]
    else:
        g = np.random.default_rng(seed)
        r = list(g.integers(0, c + 1, size=e))
        r[0] = 0
    return torch.tensor(r, dtype=torch.int32)


def past(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(E, C) bool: the rows at and past each expert's count."""
    return torch.arange(t.shape[1])[None, :] >= rows.long()[:, None]


def zeroed(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return t.masked_fill(past(t, rows)[..., None], 0)


def garbage(t: torch.Tensor, rows: torch.Tensor, g) -> torch.Tensor:
    """``t`` with the rows past the count overwritten: random bytes for
    an int8 plane, NaN, +-huge and random values for x."""
    if t.dtype == torch.int8:
        junk = torch.randint(-128, 128, t.shape, generator=g,
                             dtype=torch.int8)
    else:
        junk = torch.randn(t.shape, generator=g) * 1e30
        junk.view(-1)[::3] = float("nan")
        junk = junk.to(t.dtype)
    return torch.where(past(t, rows)[..., None], junk, t)


def matmul_operands(e, c, g):
    q = torch.randint(-128, 128, (e, c, K), generator=g, dtype=torch.int8)
    w = torch.randint(-8, 8, (e, K, N), generator=g, dtype=torch.int8)
    asc = torch.rand((e, c, 1), generator=g) * 0.1
    wsc = (torch.rand((e, 1, N), generator=g) - 0.5) * 0.02
    return q, torch.stack([pack_int4(wi) for wi in w]), asc, wsc


def planes(q):
    """q's planes, unpacked and in the wire layout, and populations."""
    lsb, msb = q & 0xF, q >> 4
    pad = (0, pad_k(K) - K)
    lp = torch.stack([pack_nibbles(torch.nn.functional.pad(p, pad))
                      for p in lsb])
    mp = torch.stack([pack_nibbles(torch.nn.functional.pad(p, pad))
                      for p in msb])
    pop = torch.stack([ref.tile_population_padded(p != 0) for p in msb])
    return dict(q=q, lsb=lsb, msb=msb, lp=lp, mp=mp, pop=pop)


# (wrapper in the dual-pass call form, 2-D plain version in that form,
# its plane operands, msb_skip, the custom op, the op's argument order)
def _dense(fn):
    def call(q, _msb, _pop, wp, asc, wsc, acc_out=False, msb_skip=True,
             **kw):
        return fn(q, wp, asc, wsc, acc_out=acc_out, **kw)
    return call


MATMULS = {
    "dual": (SM.sparqle_matmul, ref.sparqle_matmul_ref, ("lsb", "msb"),
             False),
    "draft": (SM.sparqle_matmul, ref.sparqle_matmul_ref, ("lsb", "msb"),
              True),
    "packed": (SM.sparqle_matmul_packed, ref.sparqle_matmul_packed_ref,
               ("lp", "mp"), False),
    "packed_draft": (SM.sparqle_matmul_packed, ref.sparqle_matmul_packed_ref,
                     ("lp", "mp"), True),
    "dense": (_dense(QM.quant_matmul), _dense(ref.quant_matmul_ref),
              ("q", "msb"), True)}


def _op_call(entry, args, acc_out, skip, rows):
    """The entry's custom op on CPU tensors (its CPU kernel)."""
    a0, a1, pop, wp, asc, wsc = args
    if entry == "dense":
        return QM.QUANT_MATMUL_OP.op(a0, wp, asc, wsc, acc_out, rows)
    op = SM.PACKED_OP if entry.startswith("packed") else SM.MATMUL_OP
    return op.op(a0, None if skip else a1, None if skip else pop, wp, asc,
                 wsc, acc_out, skip, rows)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("c", [1, 3, 17])
@pytest.mark.parametrize("e", [1, 8])
@pytest.mark.parametrize("entry", list(MATMULS))
def test_batched_matmul_rows_match_2d_plain(entry, e, c, pattern):
    """(a) for the five matmul entries, f32 and int32 outputs."""
    fn, plain, names, skip = MATMULS[entry]
    g = torch.Generator().manual_seed(1000 * e + c)
    q, wp, asc, wsc = matmul_operands(e, c, g)
    rows = counts(e, c, pattern, seed=c)
    clean = planes(zeroed(q, rows))
    dirty = {key: garbage(clean[key], rows, g)
             for key in ("q", "lsb", "msb", "lp", "mp")}
    for acc_out in (False, True):
        kw = dict(acc_out=acc_out, msb_skip=skip)
        want = torch.stack([plain(
            clean[names[0]][i], clean[names[1]][i], clean["pop"][i], wp[i],
            asc[i], wsc[i], **kw) for i in range(e)])
        args = (dirty[names[0]], dirty[names[1]], clean["pop"], wp, asc,
                wsc)
        got = fn(*args, rows=rows, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(_op_call(entry, args, acc_out, skip, rows), want)
        if pattern == "full":      # every row live: rows=None's bits
            assert torch.equal(fn(*args, **kw), want)
    meta = [t.to("meta") for t in args]
    out = fn(*meta, rows=rows.to("meta"), msb_skip=skip)
    assert out.device.type == "meta" and out.shape == (e, c, N)


ENCODERS = {
    "encode": (lambda x, s, m, r: SE.sparqle_encode(x, s, m, -8, 23,
                                                    rows=r),
               lambda x, s, m: ref.sparqle_encode_ref(x, s, m, -8, 23)),
    "quantize": (lambda x, s, m, r: (SE.sparqle_quantize(x, s, m, -8, 23,
                                                         rows=r),),
                 lambda x, s, m: (ref.sparqle_quantize_ref(x, s, m, -8,
                                                           23),)),
    "packed": (lambda x, s, m, r: SE.sparqle_encode_packed(x, s, m, -8, 23,
                                                           rows=r),
               lambda x, s, m: ref.sparqle_encode_packed_ref(x, s, m, -8,
                                                             23)),
    "encode_fused": (
        lambda x, s, m, r: SE.sparqle_encode_fused(x, m, -8, 23, rows=r),
        lambda x, s, m: ref.sparqle_encode_fused_ref(x, m, -8, 23)),
    "quantize_fused": (
        lambda x, s, m, r: SE.sparqle_quantize_fused(x, m, -8, 23, rows=r),
        lambda x, s, m: ref.sparqle_quantize_fused_ref(x, m, -8, 23)),
    "packed_fused": (
        lambda x, s, m, r: SE.sparqle_encode_packed_fused(x, m, -8, 23,
                                                          rows=r),
        lambda x, s, m: ref.sparqle_encode_packed_fused_ref(x, m, -8, 23))}
ENCODER_OPS = {"encode": SE.ENCODE_OP, "quantize": SE.QUANTIZE_OP,
               "packed": SE.PACKED_OP, "encode_fused": SE.FUSED_OP,
               "quantize_fused": SE.QUANTIZE_FUSED_OP,
               "packed_fused": SE.PACKED_FUSED_OP}


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("c", [1, 3, 17])
@pytest.mark.parametrize("e", [1, 8])
@pytest.mark.parametrize("entry", list(ENCODERS))
def test_batched_encoder_rows_match_2d_plain(entry, e, c, pattern):
    """(a) for the six encoder entries (bf16 x; the scale-taking ones with
    a scale that is any finite value past the count, zero included: a
    zero row encodes as 0 under any finite scale)."""
    fn, plain = ENCODERS[entry]
    g = torch.Generator().manual_seed(7 * e + c)
    x = (torch.randn((e, c, K), generator=g) * 3).to(torch.bfloat16)
    mask = torch.rand((e, K), generator=g) < 0.5
    rows = counts(e, c, pattern, seed=c + 1)
    scale = ref.activation_scale(x).float()
    junk = torch.rand(scale.shape, generator=g) * 1e4
    junk.view(-1)[::2] = 0.0
    scale = torch.where(past(x, rows)[..., None], junk, scale)
    clean = zeroed(x, rows)
    want = [torch.stack(parts) for parts in zip(*[
        plain(clean[i], scale[i], mask[i]) for i in range(e)])]
    got = fn(garbage(x, rows, g), scale, mask, rows)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fused = entry.endswith("fused")
    op_out = ENCODER_OPS[entry].op(
        garbage(x, rows, g), None if fused else scale, mask, -8, 23,
        True, rows)
    for a, b in zip(op_out, want):
        assert torch.equal(a, b)
    meta = ENCODER_OPS[entry].op(x.to("meta"), None if fused else
                                 scale.to("meta"), mask.to("meta"), -8, 23,
                                 True, rows.to("meta"))
    assert [t.shape for t in meta][:len(want)] == [t.shape for t in want]


@pytest.mark.parametrize("call", [
    lambda r: SM.sparqle_matmul(
        torch.zeros(3, K, dtype=torch.int8), torch.zeros(3, K,
                                                         dtype=torch.int8),
        torch.zeros(1, 2, dtype=torch.int32),
        torch.zeros(K // 2, N, dtype=torch.int8), torch.ones(3, 1),
        torch.ones(1, N), rows=r),
    lambda r: QM.quant_matmul(torch.zeros(3, K, dtype=torch.int8),
                              torch.zeros(K // 2, N, dtype=torch.int8),
                              torch.ones(3, 1), torch.ones(1, N), rows=r),
    lambda r: SE.sparqle_encode_fused(torch.zeros(3, K), rows=r)],
    ids=["matmul", "dense", "encoder"])
def test_rows_refused_by_the_2d_entries(call):
    with pytest.raises(ValueError, match="rows"):
        call(torch.zeros(1, dtype=torch.int32))


def test_rows_must_be_int32_of_e():
    x = torch.zeros(4, 3, K)
    with pytest.raises(ValueError, match="rows"):
        SE.sparqle_encode_fused(x, rows=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        SE.sparqle_encode_fused(x, rows=torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# (b) moe_ffn's count: the filled slots of each expert
# ---------------------------------------------------------------------------

def _record_expert_linear(monkeypatch):
    seen = []
    inner = tmoe.expert_linear

    def rec(x, w, **kw):
        seen.append((x, kw.get("rows")))
        return inner(x, w, **kw)
    monkeypatch.setattr(tmoe, "expert_linear", rec)
    return seen


@pytest.mark.parametrize("t,k,e,cf,e_loc,lo", [
    (8, 2, 8, 1.0, 8, 0),        # decode-like: capacity 2, drops
    (12, 2, 4, 1.0, 4, 0),       # capacity 6
    (10, 3, 8, 0.5, 8, 0),       # tight capacity, many drops
    (12, 2, 8, 1.0, 4, 4),       # a mesh rank's experts [4, 8)
    (8, 2, 8, 2.0, 2, 2)])       # a mesh rank's experts [2, 4)
def test_moe_ffn_rows_count_filled_slots(monkeypatch, t, k, e, cf, e_loc,
                                         lo):
    """(b) the count each routed projection gets is min(assignments the
    expert keeps, C): the dispatch buffer's filled rows, a prefix of its
    C rows, the rest zero; the three projections get the same count."""
    g = torch.Generator().manual_seed(t * e + lo)
    d, f = 16, 12
    x = torch.randn((t, d), generator=g)
    w_router = torch.randn((d, e), generator=g)
    w_gate, w_up = (torch.randn((e_loc, d, f), generator=g)
                    for _ in range(2))
    w_down = torch.randn((e_loc, f, d), generator=g)
    seen = _record_expert_linear(monkeypatch)
    tmoe.moe_ffn(x, w_router, w_gate, w_up, w_down, top_k=k,
                 capacity_factor=cf, expert_lo=lo, down_tp=None)
    cap = tmoe.capacity(t, k, e, cf)
    _, topi = tmoe.router(x, w_router, "softmax", k)
    per_expert = torch.bincount(topi.reshape(-1), minlength=e)
    want = per_expert[lo:lo + e_loc].clamp_max(cap).to(torch.int32)
    assert len(seen) == 3
    for xi, rows in seen:
        assert rows.dtype == torch.int32 and torch.equal(rows, want)
    expert_in = seen[0][0]
    filled = (expert_in != 0).any(dim=-1)
    assert torch.equal(filled.sum(dim=1).to(torch.int32), want)
    assert not (filled & past(filled[..., None], want)).any()


# ---------------------------------------------------------------------------
# (c) moe_ffn with the count = without it = JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens", [(3, 5), (8, 1)], ids=["chunk", "decode"])
@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_with_rows_equals_without_and_jax(monkeypatch, dtype,
                                                  capacity_factor, tokens):
    """(c) on tiny-moe-serve's quantized routed experts (the batched
    plain versions run the count): the count changes no bit, and the
    result is JAX's."""
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.convert import to_tensor
    from repro_torch.models import model as TM
    from test_torch_moe import ATOL, RTOL, _moe_layer
    from test_torch_zoo import tconfig
    jc, jp, tp = _moe_layer(dtype, capacity_factor)
    rng = np.random.default_rng(5)
    xj = jnp.asarray(rng.standard_normal(tokens + (jc.d_model,)),
                     jnp.float32).astype(jc.cdtype)
    seen = _record_expert_linear(monkeypatch)
    got = TM.moe_ffn(tconfig(jc), tp, to_tensor(xj))[0]
    assert [r is not None for _, r in seen] == [True] * 3
    monkeypatch.setattr(tmoe, "expert_rows", lambda *a: None)
    seen.clear()
    without = TM.moe_ffn(tconfig(jc), tp, to_tensor(xj))[0]
    assert [r for _, r in seen] == [None] * 3
    assert torch.equal(got, without)
    want = np.asarray(JM.moe_ffn(jc, jp, xj)[0].astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# (d) the count stays on the device in a traced MoE step
# ---------------------------------------------------------------------------

def _descendants(node, depth: int):
    out, todo = set(), [(node, 0)]
    while todo:
        n, d = todo.pop()
        for u in n.users:
            if u not in out and d < depth:
                out.add(u)
                todo.append((u, d + 1))
    return out


@pytest.mark.parametrize("kind", ["decode", "legacy_decode"])
def test_moe_step_trace_keeps_rows_on_device(kind):
    """(d) the engine's and the fixed-batch path's MoE decode steps,
    traced by ``make_fx`` as ``repro_torch.analysis`` traces them: no
    active finding (no host read, no data-dependent shape), and the
    count is one traced int32 tensor of the MoE layer that masks the
    rows of every routed projection's operands (on the CPU the plain
    versions: x of the 3 encoders, both planes of the 3 matmuls)."""
    from repro_torch.analysis import stepcheck as SC
    from repro_torch.analysis.findings import Allowlist, apply_allowlist
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import build_served_params
    from repro_torch.models.model import init_cache
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
    cfg = SC.tiny_configs()["moe"]
    params = build_served_params(cfg, 0, "cpu", tile_k=16)
    b, p = 2, 4
    pc = PoolConfig(n_pages=8, page_size=4)
    if kind == "decode":
        fn, state = S.make_engine_decode(cfg), init_pool_state(cfg, pc, "cpu")
    else:
        fn, state = S.make_serve_decode(cfg), init_cache(cfg, b,
                                                         p * pc.page_size,
                                                         "cpu")
    args = (params, state) + SC._step_inputs(kind, b, p, 8, 3, 1)
    step = SC.trace(fn, args, name=f"{kind}/moe/single", kind=kind,
                    family="moe", n_layers=cfg.n_layers)
    active, _ = apply_allowlist(SC.check([step]), Allowlist.load())
    assert active == [], "\n".join(f.render() for f in active)
    aten = torch.ops.aten
    filled = [n for n in step.graph.nodes
              if n.target == aten.index_put_.default
              and SC._dtype(n) == torch.int32]
    assert len(filled) == 1                   # its one MoE layer
    counts_ = [n for n in _descendants(filled[0], 3)
               if n.target == aten.sum.dim_IntList]
    assert len(counts_) == 1 and SC._dtype(counts_[0]) == torch.int32
    masks = [n for n in _descendants(counts_[0], 3)
             if n.target == aten.lt.Tensor]
    assert len(masks) == 3 + 3 * 2

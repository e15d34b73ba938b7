"""Port parity, the packed wire format: the codec of ``core/packing.py``,
the packed encoder, the packed dual-pass and draft matmuls (plain
versions), the ``kernels/ops.py`` linears, the conversion of a
packed-wire tree and the engines serving one, against the JAX package on
the same numpy inputs (CPU; the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them). The kernel-vs-plain checks that
need a card are in ``test_torch_kernels_cuda.py``.

Tolerances: none — the codec, the encoder, the matmul accumulators and
their f32 drains, the linears and the greedy streams are bit-exact. PBM
words are uint32 in JAX and int32 bit patterns in the port: they are
compared as ``np.uint32`` views."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import packing as jpk
from repro.core import qlinear as jql
from repro.core.quantize import quantize_weights as jquantize_weights
from repro.kernels import ops as jops
from repro.kernels.sparqle_encode import \
    sparqle_encode_packed as jsparqle_encode_packed
from repro.kernels.sparqle_matmul import \
    sparqle_matmul_packed as jsparqle_matmul_packed
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro.serving import SpecConfig as JSpecConfig
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.core import packing as tpk
from repro_torch.core import qlinear as tql
from repro_torch.core.quantize import QuantizedTensor, activation_scale
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import TILE_K, TILE_M
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig, SpecConfig,
                                 SpeculativeEngine)

CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
# every int8 value at least once; K ragged below 32, across 32 and 128
SWEEP = [(4, 256), (7, 37), (3, 100), (52, 5), (16, 160)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(words):
    return np.asarray(words).view(np.uint32)


def _sweep(m, k):
    x = (np.arange(m * k) % 256 - 128).astype(np.int8).reshape(m, k)
    assert len(np.unique(x)) == 256
    return x


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", SWEEP)
def test_codec_exhaustive_matches_jax(m, k):
    x = _sweep(m, k)
    jp = jpk.encode_packed(jnp.asarray(x))
    tp = tpk.encode_packed(_t(x))
    assert tp.shape == jp.shape == (m, k)
    assert tp.pbm.dtype == torch.int32
    np.testing.assert_array_equal(tp.lsb4.numpy(), np.asarray(jp.lsb4))
    np.testing.assert_array_equal(tp.pbm.numpy().view(np.uint32),
                                  np.asarray(jp.pbm))
    np.testing.assert_array_equal(tp.msb_stream.numpy(),
                                  np.asarray(jp.msb_stream))
    np.testing.assert_array_equal(tp.msb_count.numpy(),
                                  np.asarray(jp.msb_count))
    if k > 31:                       # a real column 31: bit 31 set somewhere
        assert (tp.pbm.numpy() < 0).any()
    assert int(tp.wire_bytes()) == int(jp.wire_bytes())
    assert tp.container_bytes() == jp.container_bytes()
    assert tp.dense_bytes() == jp.dense_bytes() == m * k
    assert int(tp.wire_bytes()) == int(
        tpk.measured_wire_bytes_rows(_t(x)).sum())
    np.testing.assert_array_equal(tpk.decode_packed(tp).numpy(), x)
    for a, b in zip(tpk.planes_packed(tp), jpk.planes_packed(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tu, ju = tpk.unpack_planes(tp), jpk.unpack_planes(jp)
    for f in ("lsb4", "msb4", "pbm"):
        np.testing.assert_array_equal(getattr(tu, f).numpy(),
                                      np.asarray(getattr(ju, f)))


def test_codec_primitives_match_jax():
    rng = np.random.default_rng(0)
    pbm = rng.random((5, 96)) < 0.4
    pbm[:, 31] = pbm[:, 63] = True               # bit 31 of two words
    words = tpk.pack_pbm(_t(pbm))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jpk.pack_pbm(jnp.asarray(pbm))))
    for k in (96, 70, 1):
        np.testing.assert_array_equal(
            tpk.unpack_pbm(words, k).numpy(),
            np.asarray(jpk.unpack_pbm(jnp.asarray(_u32(words)), k)))
    nib = rng.integers(-8, 8, (3, 40)).astype(np.int8)
    packed = tpk.pack_nibbles(_t(nib))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpk.pack_nibbles(jnp.asarray(nib))))
    for signed in (True, False):
        np.testing.assert_array_equal(
            tpk.unpack_nibbles(packed, signed=signed).numpy(),
            np.asarray(jpk.unpack_nibbles(jnp.asarray(packed.numpy()),
                                          signed=signed)))
    msb = np.where(rng.random((4, 64)) < 0.3,
                   rng.integers(-8, 8, (4, 64)), 0).astype(np.int8)
    stream, count = tpk.compact_msb(_t(msb), _t(msb != 0))
    js, jc = jpk.compact_msb(jnp.asarray(msb), jnp.asarray(msb != 0))
    np.testing.assert_array_equal(stream.numpy(), np.asarray(js))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        tpk.expand_msb(stream, _t(msb != 0)).numpy(), msb)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_predicted_wire_bytes_matches_jax(width):
    for n, s in ((4096, 0.0), (1000, 0.37), (7, 1.0)):
        assert tpk.predicted_wire_bytes(n, s, width=width) == \
            jpk.predicted_wire_bytes(n, s, width=width)
    with pytest.raises(ValueError):
        tpk.predicted_wire_bytes(8, 0.5, width=3)


# ---------------------------------------------------------------------------
# packed encoder
# ---------------------------------------------------------------------------

def test_encode_packed_plain_matches_pallas_f32():
    rng = np.random.default_rng(5)
    m, k = 32, 256
    x = (rng.standard_normal((m, k)) * 30).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    x[3], scale[3] = 0.0, 0.0                      # degenerate row: / 1
    got = ref.sparqle_encode_packed_ref(_t(x), _t(scale))
    want = jsparqle_encode_packed(jnp.asarray(x), jnp.asarray(scale),
                                  bm=TILE_M, bk=TILE_K, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                  np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(5, 300), (17, 37), (1, 128), (3, 20)])
def test_encode_packed_plain_is_the_codec_of_the_planes(dtype, m, k):
    """The packed encoder's bytes are the codec's on the same q, and the
    packing of the unpacked encoder's planes (padded to pad_k(K))."""
    rng = np.random.default_rng(m * k)
    x = _t(rng.standard_normal((m, k)).astype(np.float32) * 5).to(dtype)
    scale = activation_scale(x).float()
    mask = _t(rng.random(k) < 0.5)
    lp, mp, words, pop = ref.sparqle_encode_packed_ref(x, scale, mask, -8, 23)
    kp = tpk.pad_k(k)
    assert lp.shape == mp.shape == (m, kp // 2) and words.shape == (m, kp // 32)
    q = ref.sparqle_quantize_ref(x, scale, mask, -8, 23)
    enc = tpk.encode_packed(q)
    assert torch.equal(lp, enc.lsb4) and torch.equal(words, enc.pbm)
    assert torch.equal(mp, tpk.planes_packed(enc)[1])
    jenc = jpk.encode_packed(jnp.asarray(q.numpy()))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jenc.lsb4))
    np.testing.assert_array_equal(_u32(words), np.asarray(jenc.pbm))
    lsb, msb, pbm, pop2 = ref.sparqle_encode_ref(x, scale, mask, -8, 23)
    pad = lambda t: torch.nn.functional.pad(t, (0, kp - k))  # noqa: E731
    assert torch.equal(lp, tpk.pack_nibbles(pad(lsb)))
    assert torch.equal(mp, tpk.pack_nibbles(pad(msb)))
    assert torch.equal(words, tpk.pack_pbm(pad(pbm)))
    assert torch.equal(pop, pop2)


# ---------------------------------------------------------------------------
# packed dual-pass and draft matmuls
# ---------------------------------------------------------------------------

def _pop_np(pbm: np.ndarray) -> np.ndarray:
    m, k = pbm.shape
    mp, kp = -(-m // TILE_M) * TILE_M, -(-k // TILE_K) * TILE_K
    p = np.zeros((mp, kp), np.int32)
    p[:m, :k] = pbm
    return p.reshape(mp // TILE_M, TILE_M, kp // TILE_K, TILE_K).sum((1, 3))


@pytest.mark.parametrize("msb_skip", [False, True])
def test_matmul_packed_plain_matches_pallas_and_unpacked(msb_skip):
    rng = np.random.default_rng(1)
    m, k, n = 32, 512, 128
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    tiles = np.arange(k) // TILE_K
    msb = np.where(tiles % 2 == 0, q >> 4, 0).astype(np.int8)  # pop 0 tiles
    lsb = (q & 0xF).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    asc = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    wsc = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    pop = _pop_np(msb != 0)
    assert (pop == 0).any() and (pop > 0).any()
    lp, mp = (np.asarray(jpk.pack_nibbles(jnp.asarray(a))) for a in (lsb, msb))
    wp = tql.pack_int4(_t(w))
    for acc_out in (False, True):
        got = ref.sparqle_matmul_packed_ref(
            _t(lp), _t(mp), _t(pop), wp, _t(asc), _t(wsc), acc_out=acc_out,
            msb_skip=msb_skip)
        want = jsparqle_matmul_packed(
            jnp.asarray(lp), jnp.asarray(mp), jnp.asarray(pop),
            jnp.asarray(w), jnp.asarray(asc), jnp.asarray(wsc), bm=TILE_M,
            bn=128, bk=TILE_K, interpret=True, msb_skip=msb_skip,
            acc_out=acc_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        unpacked = ref.sparqle_matmul_ref(
            _t(lsb), _t(msb), _t(pop), wp, _t(asc), _t(wsc),
            acc_out=acc_out, msb_skip=msb_skip)
        assert torch.equal(got, unpacked)


def test_matmul_packed_plain_exhaustive_nibbles():
    """All 256 int8 values: the packed dual pass is q @ w and its draft
    the LSB plane's product, exactly (``tests/test_kernels.py``,
    ``tests/test_spec_decode.py``)."""
    x = _sweep(4, 128)
    w = np.random.default_rng(1).integers(-8, 8, (128, 64)).astype(np.int8)
    lp, mp = tpk.planes_packed(tpk.encode_packed(_t(x)))
    pop = _t(_pop_np((x >> 4) != 0))
    ones = (torch.ones((4, 1)), torch.ones((1, 64)))
    wp = tql.pack_int4(_t(w))
    full = ref.sparqle_matmul_packed_ref(lp, mp, pop, wp, *ones, acc_out=True)
    draft = ref.sparqle_matmul_packed_ref(lp, None, None, wp, *ones,
                                          acc_out=True, msb_skip=True)
    np.testing.assert_array_equal(full.numpy(),
                                  x.astype(np.int32) @ w.astype(np.int32))
    np.testing.assert_array_equal(
        draft.numpy(), (x & 0xF).astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(5, 300, 40), (3, 96, 24), (33, 130, 8)])
def test_matmul_packed_plain_matches_dual_pass_ragged(m, k, n):
    rng = np.random.default_rng(m + k + n)
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    want = np.asarray(jql._dual_pass_matmul(jnp.asarray(q), jnp.asarray(w),
                                            False, "packed"))
    lp, mp = tpk.planes_packed(tpk.encode_packed(_t(q)))
    got = ref.sparqle_matmul_packed_ref(
        lp, mp, _t(_pop_np((q >> 4) != 0)), tql.pack_int4(_t(w)),
        torch.ones((m, 1)), torch.ones((1, n)), acc_out=True)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ops.py linears
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def linear_inputs():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(21), (64, 192)))
    w = jquantize_weights(
        jax.random.normal(jax.random.PRNGKey(22), (192, 96)) * 0.1, bits=4,
        axis=0)
    tw = QuantizedTensor(_t(w.q), _t(w.scale), _t(w.zero), int(w.bits))
    return x, w, tw


@pytest.mark.parametrize("wire_format", ["unpacked", "packed"])
@pytest.mark.parametrize("msb_skip", [False, True])
def test_ops_sparqle_linear_matches_pallas(linear_inputs, wire_format,
                                           msb_skip):
    x, w, tw = linear_inputs
    mask = (np.arange(192) // 64) % 2 == 1
    clip = dict(col_mask=mask, clip_l=-8.0, clip_h=23.0)
    want = jops.sparqle_linear(jnp.asarray(x), w, backend="pallas",
                               wire_format=wire_format, msb_skip=msb_skip,
                               **{k: jnp.asarray(v) for k, v in clip.items()})
    got = ops.sparqle_linear(_t(x), tw, col_mask=_t(mask), clip_l=-8.0,
                             clip_h=23.0, wire_format=wire_format,
                             msb_skip=msb_skip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = ops.sparqle_linear(
        _t(x), tw, col_mask=_t(mask), clip_l=-8.0, clip_h=23.0,
        wire_format="packed" if wire_format == "unpacked" else "unpacked",
        msb_skip=msb_skip)
    assert torch.equal(got, other)


def test_ops_dense_quant_linear_matches_pallas(linear_inputs):
    x, w, tw = linear_inputs
    want = jops.dense_quant_linear(jnp.asarray(x), w)
    got = ops.dense_quant_linear(_t(x).reshape(2, 32, 192), tw)
    assert got.shape == (2, 32, 96)
    np.testing.assert_array_equal(got.reshape(64, 96).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="wire_format"):
        ops.sparqle_linear(_t(x), tw, wire_format="dense")


# ---------------------------------------------------------------------------
# a packed-wire tree: conversion, the linear, the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fparams():
    return jinit(jschema(CFG), jax.random.PRNGKey(0))


def _jq(fparams, wire_format):
    return jql.quantize_model_params(
        fparams, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
        enable_clipping=True, tile_k=16, wire_format=wire_format)


@pytest.fixture(scope="module")
def qpacked(fparams):
    return _jq(fparams, "packed")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def calls(monkeypatch):
    """Counts the serving linear's calls of each encoder (its fused-scale
    entry, counted under the encoder's name) and matmul."""
    seen = {}
    for name in ("sparqle_encode_fused", "sparqle_encode_packed_fused",
                 "sparqle_matmul", "sparqle_matmul_packed"):
        fn = getattr(tql, name)

        def counted(*a, _fn=fn, _name=name.replace("_fused", ""), **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tql, name, counted)
    return seen


def _linears(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _linears(v)]
    return [tree] if isinstance(tree, tql.SparqleLinear) else []


def test_convert_keeps_packed_wire_format(fparams, qpacked, calls):
    tree = convert_tree(_np(qpacked))
    sls = _linears(tree)
    assert len(sls) == 8            # 7 per layer stack and the head
    assert all(s.wire_format == "packed" for s in sls)
    assert all(s.wire_format == "unpacked" for s in _linears(
        convert_tree(_np(_jq(fparams, "unpacked")))))
    # one packed projection: the packed encoder and matmul run, bit-equal
    # to JAX's packed linear
    x = np.random.default_rng(3).standard_normal((5, 32)).astype(np.float32)
    jsl = jax.tree_util.tree_map(lambda a: a[0],
                                 qpacked["stages"]["s0"]["p0"]["wq"])
    got = tql.linear(_t(x), tree["stages"]["s0"]["p0"]["wq"].layer(0))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jql.linear(jnp.asarray(x), jsl)))
    assert calls == {"sparqle_encode_packed": 1, "sparqle_matmul_packed": 1}


def test_port_quantize_model_params_packed(fparams, qpacked):
    tq = tql.quantize_model_params(convert_tree(_np(fparams)), w_bits=4,
                                   k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                                   tile_k=16, wire_format="packed")
    conv = convert_tree(_np(qpacked))
    for a, b in zip(_linears(tq), _linears(conv)):
        assert a.wire_format == b.wire_format == "packed"
        assert torch.equal(a.w.q, b.w.q) and torch.equal(a.col_mask,
                                                         b.col_mask)
    with pytest.raises(ValueError, match="wire_format"):
        tql.quantize_leaf(torch.ones((4, 4)), wire_format="planes")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).tolist()


SCRIPT = [(0, _prompt(1, 11), 6), (0, _prompt(2, 5), 5),
          (2, _prompt(3, 20), 4)]            # 20 > chunk 8: chunked
KW = dict(max_decode_batch=3, token_budget=12, prefill_chunk=8,
          max_pages_per_seq=8)
POOL = dict(n_pages=24, page_size=4)


def _drive(eng, sampling_cls):
    handles = []
    for steps_before, prompt, gen in SCRIPT:
        for _ in range(steps_before):
            eng.step()
        handles.append(eng.submit(prompt, sampling_cls(max_new_tokens=gen)))
    eng.run()
    return [list(h.out_tokens) for h in handles]


def test_packed_engine_streams_match_jax_and_unpacked(fparams, qpacked,
                                                      calls):
    jeng = JEngine(CFG, qpacked, pool_config=JPool(**POOL),
                   sched_config=JSched(**KW))
    want = _drive(jeng, JSampling)
    teng = Engine(TCFG, convert_tree(_np(qpacked)),
                  pool_config=PoolConfig(**POOL),
                  sched_config=SchedulerConfig(**KW), device="cpu")
    got = _drive(teng, SamplingParams)
    assert got == want and [len(s) for s in got] == [6, 5, 4]
    assert teng.steps == jeng.steps
    assert teng.aggregate_stats()["wire_bytes_total"] == \
        jeng.aggregate_stats()["wire_bytes_total"]
    assert set(calls) == {"sparqle_encode_packed", "sparqle_matmul_packed"}
    calls.clear()
    base = Engine(TCFG, convert_tree(_np(_jq(fparams, "unpacked"))),
                  pool_config=PoolConfig(**POOL),
                  sched_config=SchedulerConfig(**KW), device="cpu")
    assert _drive(base, SamplingParams) == got
    assert set(calls) == {"sparqle_encode", "sparqle_matmul"}


def test_packed_spec_engine_streams_match_jax(qpacked, calls):
    tree = convert_tree(_np(qpacked))
    spec = dict(gamma=2)
    jeng = JSpeculativeEngine(CFG, qpacked, pool_config=JPool(**POOL),
                              sched_config=JSched(**KW),
                              spec=JSpecConfig(**spec))
    want = _drive(jeng, JSampling)
    teng = SpeculativeEngine(TCFG, tree, pool_config=PoolConfig(**POOL),
                             sched_config=SchedulerConfig(**KW),
                             spec=SpecConfig(**spec), device="cpu")
    got = _drive(teng, SamplingParams)
    assert got == want
    assert teng.steps == jeng.steps
    assert teng.aggregate_stats()["spec_acceptance_rate"] == \
        jeng.aggregate_stats()["spec_acceptance_rate"]
    assert teng.obs.registry.value("serving_spec_draft_proposed_total") > 0
    assert set(calls) == {"sparqle_encode_packed", "sparqle_matmul_packed"}

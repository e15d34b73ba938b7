"""Port parity, dense W4A8 baseline mode: the quantize-only encoder's and
the single-pass matmul's plain versions, the dense ``linear`` and the
``Engine`` on a ``mode="dense"`` tree against the JAX package on the same
numpy inputs (CPU, plain versions; the Pallas kernel in interpret mode),
and the port's dense path against its own SPARQLe path.

Tolerances: all exact. The quantized activation, the int32 accumulator,
the f32 drain and the token streams are bit-equal to JAX's; dense and
SPARQLe give the same logits bit for bit, since every int8 q is exactly
16 * msb4 + lsb4 and the drain is shared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import qlinear as jql
from repro.core.clipping import apply_clipping as japply_clipping
from repro.core.quantize import quantize_activations as jquant_act
from repro.kernels.quant_matmul import quant_matmul as jquant_matmul
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.core import qlinear as tql
from repro_torch.core.quantize import activation_scale
from repro_torch.kernels import ref
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.sparqle_encode import sparqle_quantize
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig)
from repro_torch.serving.kv_pool import init_pool_state

CFG = JConfig(name="tiny-dense", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _with_mode(tree, mode):
    """The port's served tree with every projection in ``mode``: the same
    tensors, no copy."""
    if isinstance(tree, dict):
        return {k: _with_mode(v, mode) for k, v in tree.items()}
    if isinstance(tree, tql.SparqleLinear):
        return dataclasses.replace(tree, mode=mode)
    return tree


@pytest.fixture(scope="module")
def fparams():
    return jinit(jschema(CFG), jax.random.PRNGKey(0))


def _jquantize(fparams, mode):
    return jql.quantize_model_params(
        fparams, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
        mode=mode, enable_clipping=True, tile_k=16)


# ---------------------------------------------------------------------------
# kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ones", [True, False])
def test_quant_matmul_plain_matches_pallas(ones):
    """Bit-exact with the Pallas kernel: with unit scales its f32 output
    is the int32 accumulator itself (|acc| < 2**24), with random scales
    the drain in the same order."""
    rng = np.random.default_rng(int(ones))
    m, k, n = 32, 512, 128
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    asc, wsc = (np.ones(s, np.float32) if ones else
                rng.uniform(0.01, 0.1, s).astype(np.float32)
                for s in ((m, 1), (1, n)))
    want = np.asarray(jquant_matmul(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(asc), jnp.asarray(wsc),
        bm=16, bn=128, bk=128, interpret=True))
    wp = tql.pack_int4(_t(w))
    got = ref.quant_matmul_ref(_t(q), wp, _t(asc), _t(wsc))
    np.testing.assert_array_equal(got.numpy(), want)
    if ones:
        acc = ref.quant_matmul_ref(_t(q), wp, _t(asc), _t(wsc),
                                   acc_out=True)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), want.astype(np.int32))
    # the wrapper takes the plain version on the CPU
    assert torch.equal(quant_matmul(_t(q), wp, _t(asc), _t(wsc)), got)


@pytest.mark.parametrize("m,k,n", [(16, 4096, 128), (32, 512, 256)])
def test_quant_matmul_plain_matches_pallas_extreme_operands(m, k, n):
    """q = -128 and w = -8 everywhere (every product the largest, +1024):
    the port's CPU path = the Pallas kernel (tile-aligned shapes, as it
    takes them), as int32 and as the f32 drain."""
    q = np.full((m, k), -128, np.int8)
    w = np.full((k, n), -8, np.int8)
    asc = np.full((m, 1), 0.03, np.float32)
    wsc = np.full((1, n), 0.002, np.float32)
    want = np.asarray(jquant_matmul(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(asc), jnp.asarray(wsc),
        bm=16, bn=128, bk=128, interpret=True))
    wp = tql.pack_int4(_t(w))
    got = quant_matmul(_t(q), wp, _t(asc), _t(wsc))
    np.testing.assert_array_equal(got.numpy(), want)
    acc = quant_matmul(_t(q), wp, _t(asc), _t(wsc), acc_out=True)
    assert (acc == 1024 * k).all()


@pytest.mark.parametrize("m,k,n", [(5, 96, 40), (33, 130, 8)])
def test_quant_matmul_plain_equals_dual_pass_on_the_planes(m, k, n):
    """acc(q) = acc(lsb4, msb4) bit for bit, pop-0 tiles included."""
    rng = np.random.default_rng(m + k + n)
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    q[:, :64] = rng.integers(0, 16, (m, 64))       # MSB-free columns
    w = tql.pack_int4(_t(rng.integers(-8, 8, (k, n)).astype(np.int8)))
    asc = _t(rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32))
    wsc = _t(rng.uniform(0.01, 0.1, (1, n)).astype(np.float32))
    qt = _t(q)
    lsb, msb = qt & 0xF, qt >> 4
    pop = ref.tile_population_padded(msb != 0)
    for acc_out in (False, True):
        assert torch.equal(
            ref.quant_matmul_ref(qt, w, asc, wsc, acc_out=acc_out),
            ref.sparqle_matmul_ref(lsb, msb, pop, w, asc, wsc,
                                   acc_out=acc_out))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(5, 300), (1, 128)])
def test_quantize_plain_matches_quantize_activations_and_clip(dtype, m, k):
    """The quantize-only plain encoder = JAX's quantize_activations ->
    apply_clipping, with the per-token scale formed in x's dtype."""
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 8, (m, 1))).astype(
        np.float32)
    if m > 1:
        x[0] = 0.0
    mask = rng.random(k) < 0.5
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(japply_clipping(jquant_act(xj).q, jnp.asarray(mask),
                                      -8, 23))
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    scale = activation_scale(xt).float()
    got = ref.sparqle_quantize_ref(xt, scale, _t(mask), -8, 23)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sparqle_quantize(xt, scale, _t(mask), -8, 23), got)
    lsb, msb, _, _ = ref.sparqle_encode_ref(xt, scale, _t(mask), -8, 23)
    assert torch.equal(msb * 16 + lsb, got)


# ---------------------------------------------------------------------------
# the dense linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_linear_matches_jax_and_sparqle(dtype):
    """The port's dense linear = JAX's dense linear on the same converted
    SparqleLinear, and = the port's SPARQLe linear on the same weight."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    sl = jql.quantize_leaf(jnp.asarray(w), tile_k=16, mode="dense")
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jql.linear(xj, sl).astype(jnp.float32))
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    tsl = convert_tree(sl)
    assert tsl.mode == "dense" and tsl.packed
    got = tql.linear(xt, tsl)
    np.testing.assert_array_equal(got.float().numpy(), want)
    sparqle = tql.linear(xt, dataclasses.replace(tsl, mode="sparqle"))
    assert torch.equal(got, sparqle)
    with tql.msb_skip_scope():            # inert in dense mode, as in JAX
        assert torch.equal(tql.linear(xt, tsl), got)


def test_linear_rejects_unknown_mode():
    sl = tql.quantize_leaf(torch.randn(64, 16), tile_k=16, mode="sparse")
    with pytest.raises(ValueError, match="mode"):
        tql.linear(torch.randn(3, 64), sl)


# ---------------------------------------------------------------------------
# steps and engine
# ---------------------------------------------------------------------------

def test_dense_and_sparqle_steps_give_equal_logits(fparams):
    """A prefill chunk and a decode step through the dense and the SPARQLe
    tree of the same weights: logits, telemetry and pool bit-equal."""
    tparams = convert_tree(_np(_jquantize(fparams, "sparqle")))
    runs = []
    for mode in ("sparqle", "dense"):
        params = _with_mode(tparams, mode)
        pool = init_pool_state(TCFG, PoolConfig(n_pages=8, page_size=4))
        toks = _t(np.arange(3, 11, dtype=np.int32)[None])
        table = _t(np.array([[2, 5, 0, 0]], np.int32))
        pl, _, pt = TS.make_engine_prefill_chunk(TCFG)(params, pool, toks, 0,
                                                       8, table)
        dl, _, dt = TS.make_engine_decode(TCFG)(
            params, pool, _t(np.array([7, 0], np.int32)),
            _t(np.array([8, 0], np.int32)),
            _t(np.array([[2, 5, 6, 0], [0, 0, 0, 0]], np.int32)))
        runs.append((pl, pt, dl, dt, pool))
    (pl_s, pt_s, dl_s, dt_s, pool_s), (pl_d, pt_d, dl_d, dt_d, pool_d) = runs
    assert torch.equal(pl_s, pl_d) and torch.equal(dl_s, dl_d)
    for a, b in ((pt_s, pt_d), (dt_s, dt_d)):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    lp_s, lp_d = pool_s["stages"]["s0"]["p0"], pool_d["stages"]["s0"]["p0"]
    for key in lp_s:
        assert torch.equal(lp_s[key], lp_d[key]), key


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).tolist()


def test_dense_engine_streams_match_jax_and_sparqle(fparams):
    """The port's Engine on a dense tree = JAX's Engine on its dense tree,
    and = the port's Engine on the SPARQLe tree of the same weights."""
    jparams = _jquantize(fparams, "dense")
    tparams = convert_tree(_np(jparams))
    kw = dict(max_decode_batch=2, token_budget=16, prefill_chunk=8,
              max_pages_per_seq=8)
    prompts = [_prompt(1, 11), _prompt(2, 6), _prompt(3, 9)]
    j = JEngine(CFG, jparams, pool_config=JPool(n_pages=16, page_size=4),
                sched_config=JSched(**kw))
    jh = [j.submit(p, JSampling(max_new_tokens=6)) for p in prompts]
    j.run()
    streams = []
    for mode in ("dense", "sparqle"):
        t = Engine(TCFG, _with_mode(tparams, mode), device="cpu",
                   pool_config=PoolConfig(n_pages=16, page_size=4),
                   sched_config=SchedulerConfig(**kw))
        th = [t.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
        t.run()
        streams.append([h.out_tokens for h in th])
        assert t.steps == j.steps
    assert streams[0] == [h.out_tokens for h in jh]
    assert streams[1] == streams[0]


def test_serve_mode_dense_smoke_on_cpu(capsys):
    serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                "--mode", "dense", "--batch", "2", "--prompt-len", "12",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert "quantized (dense)" in out
    assert "2 requests, 6 tokens" in out

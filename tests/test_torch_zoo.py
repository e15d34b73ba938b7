"""Port parity, the model zoo the JAX engine serves: yi-6b (GQA kv=4,
d_ff 11008), starcoder2-3b (LayerNorm, biases, the plain tanh-GELU MLP)
and deepseek-moe-16b (a dense first layer, then routed + shared MoE
FFNs, MHA). Same numpy inputs, JAX's quantized tree converted, CPU plain
versions.

Tolerances. At bf16 LayerNorm, the tanh GELU and the biased MLP equal
JAX's eager ops bit for bit (both round each op to bf16). At f32 they
differ by a few ulps (XLA's tanh, rsqrt and mean are not torch's), so
they are held within rtol 4e-6, atol 1e-6. The greedy streams are held
equal at f32: the smoke configs run with ``dtype="float32"``, because at
bf16 XLA's jitted steps keep excess f32 precision across fused ops (see
``tests/test_torch_legacy_bf16.py``), which no eager program reproduces.

Streams: the port's ``Engine`` = JAX's ``Engine``; the port's
``SpeculativeEngine`` (gamma 2) = its base engine = JAX's streams, and
for deepseek-moe-16b (whose verify window routes one MoE call a window
position) also JAX's speculative engine's counters; the port's dense and
packed-wire trees give the same streams (in JAX both equal SPARQLe's by
construction: equal int32 accumulators); ``--legacy`` = JAX's jitted
``prefill``/``decode_step``, logits within ``LEGACY_ATOL`` a step and the
greedy tokens equal up to any near-tie an f32 ulp flips (see
:func:`assert_greedy_agrees`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jdeepseek
from repro.configs import starcoder2_3b as jstarcoder
from repro.configs import yi_6b as jyi
from repro.core.qlinear import quantize_model_params as jquantize
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro.serving import SpecConfig as JSpecConfig
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_tensor
from repro_torch.core.qlinear import tree_index
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.schema import _map_schema
from repro_torch.models.schema_builder import build_schema as tschema
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig, SpecConfig,
                                 SpeculativeEngine)

JCONFIGS = {"yi-6b": jyi, "starcoder2-3b": jstarcoder,
            "deepseek-moe-16b": jdeepseek}
ARCHS = tuple(JCONFIGS)
RTOL, ATOL = 4e-6, 1e-6
PS, GAMMA = 4, 2
SCHED = dict(max_decode_batch=3, token_budget=24, prefill_chunk=8,
             max_pages_per_seq=8)


def jconfig(arch):
    """The smoke config at f32 (see the module docstring)."""
    return JCONFIGS[arch].SMOKE.replace(dtype="float32")


def tconfig(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def quantized(jc, seed=0, **kw):
    """JAX's quantized tree of ``jc`` and the port's conversion of it."""
    qp = jquantize(jinit(jschema(jc), jax.random.PRNGKey(seed)), w_bits=4,
                   k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                   enable_clipping=True, tile_k=16, **kw)
    return qp, convert_tree(jax.tree_util.tree_map(np.asarray, qp))


def with_fields(tree, **fields):
    """Every ``SparqleLinear`` of a port tree with ``fields`` replaced."""
    if isinstance(tree, dict):
        return {k: with_fields(v, **fields) for k, v in tree.items()}
    if hasattr(tree, "wire_format"):
        return dataclasses.replace(tree, **fields)
    return tree


def prompts(vocab, lens=((1, 11), (2, 5), (3, 20))):
    return [np.random.default_rng(s).integers(0, vocab, n).tolist()
            for s, n in lens]


def drive(eng, sampling_cls, reqs, gen=6):
    handles = [eng.submit(p, sampling_cls(max_new_tokens=gen)) for p in reqs]
    eng.run()
    return [list(h.out_tokens) for h in handles]


def port_engine(tc, tparams, gamma=0):
    kw = dict(pool_config=PoolConfig(n_pages=24, page_size=PS),
              sched_config=SchedulerConfig(**SCHED), device="cpu")
    if gamma:
        return SpeculativeEngine(tc, tparams, spec=SpecConfig(gamma=gamma),
                                 **kw)
    return Engine(tc, tparams, **kw)


def jax_engine(jc, qparams, gamma=0):
    kw = dict(pool_config=JPool(n_pages=24, page_size=PS),
              sched_config=JSched(**SCHED))
    if gamma:
        return JSpeculativeEngine(jc, qparams, spec=JSpecConfig(gamma=gamma),
                                  **kw)
    return JEngine(jc, qparams, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(arch, JAX config, port config, JAX tree, port tree, JAX streams)."""
    jc = jconfig(request.param)
    qp, tp = quantized(jc)
    reqs = prompts(jc.vocab)
    return dict(arch=request.param, jc=jc, tc=tconfig(jc), qp=qp, tp=tp,
                reqs=reqs, jstreams=drive(jax_engine(jc, qp), JSampling,
                                          reqs))


# ---------------------------------------------------------------------------
# configs and schemas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch, smoke):
    jmod = JCONFIGS[arch]
    jc = jmod.SMOKE if smoke else jmod.CONFIG
    tc = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.hd == jc.hd


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_matches_jax(arch):
    """Every leaf path, shape and init of the port's schema = JAX's."""
    jc = JCONFIGS[arch].SMOKE
    mine, theirs = {}, {}
    _map_schema(tschema(tconfig(jc)),
                lambda p, s: mine.__setitem__(p, (s.shape, s.init, s.scale)))
    jflat = jax.tree_util.tree_flatten_with_path(
        jschema(jc), is_leaf=lambda x: hasattr(x, "init"))[0]
    for path, s in jflat:
        key = "/".join(k.key for k in path)
        theirs[key] = (tuple(s.shape), s.init, s.scale)
    assert mine == theirs


# ---------------------------------------------------------------------------
# the new layers, op by op
# ---------------------------------------------------------------------------

def _pair(x, dtype):
    xj = jnp.asarray(x, jnp.float32).astype(dtype)
    return xj, to_tensor(xj)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == jnp.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((6, 96)) * 3, dtype)
    g, b = rng.standard_normal(96), rng.standard_normal(96)
    gj, bj = jnp.asarray(g, jnp.float32), jnp.asarray(b, jnp.float32)
    _close(TL.layer_norm(xt, to_tensor(gj), to_tensor(bj), 1e-6),
           JL.layer_norm(xj, gj, bj, 1e-6), dtype)
    _close(TL.gelu_tanh(xt), jax.nn.gelu(xj, approximate=True), dtype)
    assert TL.gelu_tanh(xt).dtype == xt.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_gelu_mlp_and_layer_norm_block_match_jax(dtype):
    """starcoder2's FFN (LayerNorm, biased w_fc, tanh GELU, biased
    w_proj) on JAX's quantized weights, with non-zero biases and norm
    parameters."""
    jc = JCONFIGS["starcoder2-3b"].SMOKE.replace(dtype=dtype)
    qp, tp = quantized(jc)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(lambda v: v[0], qp["stages"]["s0"]["p0"])
    for name in ("b_fc", "b_proj"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.1,
                               jnp.float32)
    jp["ln2"] = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                 for k, v in jp["ln2"].items()}
    tpp = tree_index(tp["stages"]["s0"]["p0"], 0)
    for name in ("b_fc", "b_proj"):
        tpp[name] = to_tensor(jp[name])
    tpp["ln2"] = {k: to_tensor(v) for k, v in jp["ln2"].items()}
    xj, xt = _pair(rng.standard_normal((2, 5, jc.d_model)), jc.cdtype)
    _close(TM.dense_ffn(tconfig(jc), tpp, xt), JM.dense_ffn(jc, jp, xj),
           jc.cdtype)


def test_check_paged_support_accepts_the_zoo():
    for arch in ARCHS + ("granite-8b",):
        TM.check_paged_support(get_config(arch))
        TM.check_contiguous_support(get_config(arch))
    cfg = get_config("yi-6b").replace(sliding_window=64)
    with pytest.raises(NotImplementedError, match="full-attention"):
        TM.check_paged_support(cfg)
    TM.check_contiguous_support(cfg)


# ---------------------------------------------------------------------------
# greedy streams against JAX
# ---------------------------------------------------------------------------

def test_engine_streams_match_jax(served):
    ts = drive(port_engine(served["tc"], served["tp"]), SamplingParams,
               served["reqs"])
    assert ts == served["jstreams"]
    assert [len(s) for s in ts] == [6, 6, 6]


def test_spec_engine_streams_match_base_and_jax(served):
    te = port_engine(served["tc"], served["tp"], gamma=GAMMA)
    ts = drive(te, SamplingParams, served["reqs"])
    assert ts == served["jstreams"]
    if served["arch"] == "deepseek-moe-16b":
        je = jax_engine(served["jc"], served["qp"], gamma=GAMMA)
        assert drive(je, JSampling, served["reqs"]) == ts
        ja, ta = je.aggregate_stats(), te.aggregate_stats()
        for key in ("spec_acceptance_rate", "spec_tokens_per_step",
                    "steps", "wire_bytes_total"):
            assert ta[key] == ja[key], key


@pytest.mark.parametrize("fields", [dict(mode="dense"),
                                    dict(wire_format="packed")],
                         ids=["dense", "packed"])
def test_dense_and_packed_streams_match_jax(served, fields):
    tp = with_fields(served["tp"], **fields)
    ts = drive(port_engine(served["tc"], tp), SamplingParams, served["reqs"])
    assert ts == served["jstreams"]


def _legacy_greedy(prefill, decode, params, prompt, gen, wrap):
    toks = wrap(np.asarray([prompt], np.int32))
    tok, cache = prefill(params, {"tokens": toks})
    out = [int(tok[0])]
    for i in range(gen - 1):
        pos = wrap(np.full((1,), len(prompt) + i, np.int32))
        tok, cache = decode(params, cache, wrap(np.asarray([out[-1]],
                                                           np.int32)), pos)
        out.append(int(tok[0]))
    return out


def prefill_into(cfg, max_len):
    """``make_serve_prefill_into`` over caches from ``init_cache``, in
    ``make_serve_prefill``'s form: (params, batch) -> (token, caches)."""
    step = TS.make_serve_prefill_into(cfg)

    def prefill(params, batch):
        cache = TM.init_cache(cfg, batch["tokens"].shape[0], max_len)
        return step(params, cache, *batch.values()), cache
    return prefill


# An f32 ulp of XLA's exp/tanh against torch's can move one int8
# activation rounding by a step inside a layer; at the smoke widths that
# moves a logit by up to ~4e-3 (tiny-moe-serve's 20-token --legacy
# prefill). Where it flips a near-tie, the streams part there.
LEGACY_ATOL = 1e-2


def legacy_logits(M, cfg, params, prompt, gen, wrap, to_np):
    """The fixed-batch path's greedy stream and its logits a step, from
    ``M.prefill``/``M.decode_step`` (jitted by ``wrap`` on the JAX side)."""
    prefill, decode = wrap(M.prefill, cfg, len(prompt) + gen)
    logits, cache = prefill(params, np.asarray([prompt], np.int32))
    steps = [to_np(logits)[0]]
    out = [int(np.argmax(steps[-1]))]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, np.asarray([out[-1]], np.int32),
                               np.full((1,), len(prompt) + i, np.int32))
        steps.append(to_np(logits)[0])
        out.append(int(np.argmax(steps[-1])))
    return out, steps


def jax_legacy(jc, params, prompt, gen):
    def wrap(_, cfg, max_len):
        pf = jax.jit(lambda p, t: JM.prefill(cfg, p, {"tokens": t},
                                             max_len=max_len))
        dc = jax.jit(lambda p, c, t, s: JM.decode_step(cfg, p, c, t, s))
        return pf, dc
    return legacy_logits(JM, jc, params, prompt, gen, wrap, np.asarray)


def port_legacy(tc, params, prompt, gen):
    def wrap(_, cfg, max_len):
        t = torch.from_numpy
        return ((lambda p, x: TM.prefill(cfg, p, {"tokens": t(x)},
                                         max_len=max_len)),
                (lambda p, c, x, s: TM.decode_step(cfg, p, c, t(x), t(s))))
    return legacy_logits(TM, tc, params, prompt, gen, wrap,
                         lambda v: v.numpy())


def assert_greedy_agrees(j, t, atol=LEGACY_ATOL):
    """The streams are equal, step for step with logits within ``atol``,
    up to a step where the two argmaxes part; there JAX's logits of the
    two tokens must lie within ``atol`` of each other (an f32 rounding
    flipped a near-tie), and the comparison ends."""
    (jout, jsteps), (tout, tsteps) = j, t
    for i, (a, b) in enumerate(zip(jout, tout)):
        np.testing.assert_allclose(tsteps[i], jsteps[i], atol=atol)
        if a != b:
            assert jsteps[i][a] - jsteps[i][b] < atol, (i, a, b)
            return i
    return None


def test_legacy_streams_match_jax(served):
    """The fixed-batch path (``--legacy``) against JAX's jitted
    ``prefill``/``decode_step``; the greedy helper of
    ``tests/test_torch_legacy.py`` runs the port's serve steps, whose
    streams must be the ones compared, with the prefill allocating its
    caches and into caches made outside it."""
    jc, tc = served["jc"], served["tc"]
    for p in served["reqs"]:
        j = jax_legacy(jc, served["qp"], p, 5)
        t = port_legacy(tc, served["tp"], p, 5)
        assert_greedy_agrees(j, t)
        assert _legacy_greedy(
            TS.make_serve_prefill(tc, len(p) + 5), TS.make_serve_decode(tc),
            served["tp"], p, 5, torch.from_numpy) == t[0]
        assert _legacy_greedy(
            prefill_into(tc, len(p) + 5), TS.make_serve_decode(tc),
            served["tp"], p, 5, torch.from_numpy) == t[0]

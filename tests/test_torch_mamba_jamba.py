"""Port parity, the SSD family on the fixed-batch path (``serve
--legacy``): mamba2-2.7b (an attention-free stack of SSD mixers without
FFNs, tied head) and jamba-v0.1-52b (a period of SSD and attention
layers, 1 attention in every ``attn_every``, MoE on every second
layer). Same numpy inputs, JAX's quantized tree converted
(``convert.py``), CPU plain versions, f32: mamba2's SMOKE config and
jamba's cut to one period of 4 (``SMOKE.replace(n_layers=4,
attn_every=4)``: ssd+dense, ssd+moe, attn+dense, ssd+moe), which keeps
JAX's compiles short. Each JAX function is jitted once a module and
arch; the SMOKE chunk (16) over 20-token prompts runs a ragged scan.

Tolerances: the mixer's output, the SSD states and logits within 1e-4
of max |value| (the plain einsums sum in other orders than XLA's); the
greedy streams identical; the decode step traced through the CUDA-graph
stand-in bit-equal to eager, the states included.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v01_52b as jjamba
from repro.configs import mamba2_2p7b as jmamba
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.registry import cache_schema as jcache_schema
from repro.models.schema import init_params as jinit
from repro.models.schema import param_count as jparam_count
from repro.models.schema_builder import build_schema as jschema
from repro.models.stages import LayerDef as JLayerDef
from repro.models.stages import build_stages as jstages
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.core import qlinear as tql
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models import schema as tschema_mod
from repro_torch.models.schema import _map_schema
from repro_torch.models.schema_builder import build_schema as tschema
from repro_torch.models.stages import LayerDef, build_stages

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graphs import FxGraph  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_random, replay_vs_eager  # noqa: E402

JCONFIGS = {"mamba2-2.7b": jmamba, "jamba-v0.1-52b": jjamba}
ARCHS = tuple(JCONFIGS)
TOL = 1e-4          # of max |value|
PROMPT, GEN, B = 20, 6, 2
CPU = torch.device("cpu")
SSD_FLOATS = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "gn")
# the plans held against JAX's beside CONFIG and SMOKE: the CPU tests'
# jamba cut and the card's 2-layer cross-check cuts
CUTS = {"mamba2-2.7b": [dict(n_layers=2)],
        "jamba-v0.1-52b": [dict(n_layers=4, attn_every=4),
                           dict(n_layers=2, attn_every=2, n_experts=4)]}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jconfig(arch):
    smoke = JCONFIGS[arch].SMOKE
    if arch == "jamba-v0.1-52b":
        smoke = smoke.replace(n_layers=4, attn_every=4)
    return smoke.replace(dtype="float32")


def tconfig(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _randomize(params, rng):
    """Every norm gain and the SSD mixer's float leaves drawn away from
    their zero or one inits, so that each must cross over (a_log small:
    A = -exp(a_log) stays near -1)."""
    scale = {"gamma": 0.5, "gn": 0.5, "conv_b": 0.5, "dt_bias": 0.5,
             "a_log": 0.2, "d_skip": 0.5}
    if isinstance(params, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * scale[k]
                                + (1.0 if k == "d_skip" else 0.0),
                                jnp.float32)
                    if k in scale else _randomize(v, rng))
                for k, v in params.items()}
    return params


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want|, both finite."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """JAX's config and quantized tree (float leaves randomized), the
    port's config and conversion, the prompts and JAX's entry points,
    each jitted once."""
    arch = request.param
    jc = jconfig(arch)
    rng = np.random.default_rng(3)
    floats = _randomize(jinit(jschema(jc), jax.random.PRNGKey(0)), rng)
    qp = jax.jit(lambda f: jquantize(f, w_bits=4, k_percent=50.0,
                                     clip_l=-8.0, clip_h=23.0,
                                     enable_clipping=True, tile_k=16))(floats)
    tokens = rng.integers(0, jc.vocab, (B, PROMPT)).astype(np.int32)
    max_len = PROMPT + GEN
    fns = dict(
        prefill=jax.jit(lambda p, bt: JM.prefill(jc, p, bt,
                                                 max_len=max_len)),
        decode=jax.jit(lambda p, c, t, q: JM.decode_step(jc, p, c, t, q)),
        hidden=jax.jit(lambda p, bt: JM.forward_hidden(jc, p, bt)),
        serve_prefill=jax.jit(JS.make_serve_prefill(jc, max_len)),
        serve_decode=jax.jit(JS.make_serve_decode(jc)))
    return dict(arch=arch, jc=jc, tc=tconfig(jc), qp=qp,
                tp=convert_tree(_np(qp)), tokens=tokens, jax=fns)


def _plan(stages):
    return [([dataclasses.asdict(ld) for ld in st.period], st.repeat)
            for st in stages]


# ---------------------------------------------------------------------------
# configs, plans, schemas, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_stages_match_jax(arch, smoke):
    jmod = JCONFIGS[arch]
    jc = jmod.SMOKE if smoke else jmod.CONFIG
    tc = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert _plan(build_stages(tc)) == _plan(jstages(jc))
    for cut in CUTS[arch]:
        assert _plan(build_stages(tc.replace(**cut))) == \
            _plan(jstages(jc.replace(**cut)))


def test_full_config_dims_and_plans():
    """mamba2: d_inner 5,120 = 80 heads of 64, 64 [ssd] layers with no
    FFN; jamba: d_inner 8,192 = 128 heads of 64, one period of 8 (the
    attention at index 4, MoE at the odd indices) repeated 4 times; the
    cut periods of the CPU tests and the card's cross-check."""
    m, j = get_config("mamba2-2.7b"), get_config("jamba-v0.1-52b")
    assert (m.d_inner, m.d_inner // m.ssm_head_dim) == (5120, 80)
    assert (j.d_inner, j.d_inner // j.ssm_head_dim) == (8192, 128)
    assert _plan(build_stages(m)) == [([dataclasses.asdict(
        LayerDef("ssd", "none"))], 64)]
    (st,) = build_stages(j)
    assert st.repeat == 4
    assert [(ld.mixer, ld.ffn) for ld in st.period] == [
        ("ssd", "dense"), ("ssd", "moe"), ("ssd", "dense"), ("ssd", "moe"),
        ("attn", "dense"), ("ssd", "moe"), ("ssd", "dense"), ("ssd", "moe")]
    (cut,) = build_stages(j.replace(**CUTS["jamba-v0.1-52b"][0]))
    assert [(ld.mixer, ld.ffn) for ld in cut.period] == [
        ("ssd", "dense"), ("ssd", "moe"), ("attn", "dense"), ("ssd", "moe")]
    (xc,) = build_stages(j.replace(**CUTS["jamba-v0.1-52b"][1]))
    assert [(ld.mixer, ld.ffn) for ld in xc.period] == [
        ("ssd", "dense"), ("attn", "moe")]
    with pytest.raises(AssertionError):
        build_stages(j.replace(n_layers=12))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_schema_matches_jax(arch, smoke):
    """Every leaf path, shape, dtype, init and scale of the port's schema
    equals JAX's: the SSD leaves (``w_in`` (d, 2 din + 2 g n + nh),
    ``conv_w`` (W, din + 2 g n), ...), jamba's attention, dense and MoE
    layers, mamba2's FFN-less layers and tied head."""
    jc = JCONFIGS[arch].SMOKE if smoke else JCONFIGS[arch].CONFIG
    mine, theirs = {}, {}
    _map_schema(tschema(tconfig(jc)), lambda p, s: mine.__setitem__(
        p, (s.shape, str(s.dtype).split(".")[-1], s.init, s.scale)))
    jflat = jax.tree_util.tree_flatten_with_path(
        jschema(jc), is_leaf=lambda x: hasattr(x, "init"))[0]
    for path, s in jflat:
        theirs["/".join(k.key for k in path)] = (
            tuple(s.shape), jnp.dtype(s.dtype).name, s.init, s.scale)
    assert mine == theirs
    din, g, n = jc.d_inner, jc.ssm_groups, jc.ssm_state
    nh = din // jc.ssm_head_dim
    w_in = [v for k, v in mine.items() if k.endswith("w_in")]
    assert w_in and all(v[0][1:] == (jc.d_model, 2 * din + 2 * g * n + nh)
                        for v in w_in)
    assert ("lm_head" in mine) == (arch == "jamba-v0.1-52b")
    if arch == "mamba2-2.7b":
        assert not any("w_gate" in k or "ln2" in k for k in mine)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    """The parameter count from the abstract schemas (no tensor
    allocated) equals JAX's: mamba2 ~2.7 B, jamba ~52 B."""
    sizes = []
    _map_schema(tschema(get_config(arch)),
                lambda _, s: sizes.append(int(np.prod(s.shape))))
    n = sum(sizes)
    assert n == jparam_count(jschema(JCONFIGS[arch].CONFIG))
    lo, hi = {"mamba2-2.7b": (2.5e9, 2.9e9),
              "jamba-v0.1-52b": (50e9, 54e9)}[arch]
    assert lo < n < hi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_cache_schema(arch, dtype):
    """The port's contiguous caches have the shapes and dtypes of JAX's
    ``cache_schema``: an SSD layer's state ``h`` (B, G, H/G, P, N) f32
    and conv tail (B, W-1, din + 2GN) in the compute dtype, jamba's
    attention layer its packed K/V; each layer-stacked, zeroed."""
    jc = JCONFIGS[arch].SMOKE.replace(dtype=dtype)
    got = TM.init_cache(tconfig(jc), 3, 10)
    want = jcache_schema(jc, 3, 10)
    n = 0
    for si, st in want["stages"].items():
        assert set(got["stages"][si]) == set(st)
        for pi, layer in st.items():
            assert set(got["stages"][si][pi]) == set(layer)
            for key, spec in layer.items():
                t = got["stages"][si][pi][key]
                assert tuple(t.shape) == tuple(spec.shape), (pi, key)
                assert str(t.dtype).split(".")[-1] == \
                    jnp.dtype(spec.dtype).name, (pi, key)
                assert not t.any()
                n += key == "h"
    assert n == sum(1 for s in jstages(jc) for ld in s.period
                    if ld.mixer == "ssd")


def test_contiguous_support_takes_ssd():
    """Both archs serve on the contiguous path; the KV4 check runs only
    where an attention layer exists (mamba2 has no heads: its kv_bits and
    hd are never read, jamba's are); the paged path refuses SSD layers,
    naming the mixer."""
    mamba, jamba = get_config("mamba2-2.7b"), get_config("jamba-v0.1-52b")
    for cfg in (mamba, jamba):
        TM.check_contiguous_support(cfg)
        with pytest.raises(NotImplementedError, match="mixer='ssd'"):
            TM.check_paged_support(cfg)
    TM.check_contiguous_support(mamba.replace(kv_bits=8))
    with pytest.raises(NotImplementedError, match="kv_bits=8"):
        TM.check_contiguous_support(jamba.replace(kv_bits=8))


def test_expert_draw_chunks_jamba_layers():
    """jamba's routed layer (16, 4096, 14336), 3.76 GB in f32, is drawn
    a chunk of experts at a time (4 a chunk under EXPERT_DRAW_BYTES);
    on the SMOKE config the served tree quantizes ``w_in``/``w_out`` and
    keeps the SSD mixer's other leaves float."""
    cfg = get_config("jamba-v0.1-52b")
    layer = cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 4
    assert layer > tschema_mod.EXPERT_DRAW_BYTES
    assert tschema_mod.EXPERT_DRAW_BYTES // (cfg.d_model * cfg.moe_d_ff
                                             * 4) == 4
    tree = tschema_mod.init_quantized_params(
        tschema(get_config("jamba-v0.1-52b", smoke=True)), 0, CPU,
        tile_k=16)
    p0 = tree["stages"]["s0"]["p0"]
    assert isinstance(p0["w_in"], tql.SparqleLinear)
    assert isinstance(p0["w_out"], tql.SparqleLinear)
    assert all(isinstance(p0[k], torch.Tensor) and p0[k].is_floating_point()
               for k in SSD_FLOATS)


def test_convert_carries_float_ssd_leaves(model):
    """``convert_tree`` of JAX's quantized tree: the SSD mixer's float
    leaves arrive as f32 tensors equal to JAX's, its two projections as
    served projections."""
    qp = model["qp"]["stages"]["s0"]["p0"]
    tp = model["tp"]["stages"]["s0"]["p0"]
    for k in SSD_FLOATS:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(qp[k]))
    assert isinstance(tp["w_in"], tql.SparqleLinear)
    assert isinstance(tp["w_out"], tql.SparqleLinear)


# ---------------------------------------------------------------------------
# the mixer in the model: ssd_full, ssd_decode
# ---------------------------------------------------------------------------

def test_ssd_full_and_decode_match_jax(model):
    """``ssd_full`` (output, and the state and conv tail it writes into
    a zeroed layer cache in place) and two ``ssd_decode`` steps from
    there (outputs, and the cache views updated in place) against JAX's,
    within 1e-4 of max |value|."""
    jc, tc = model["jc"], model["tc"]
    jp = jax.tree_util.tree_map(lambda v: v[0],
                                model["qp"]["stages"]["s0"]["p0"])
    tp = tql.tree_index(model["tp"]["stages"]["s0"]["p0"], 0)
    ld, jld = LayerDef("ssd", "none"), JLayerDef("ssd", "none")
    s = 21
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, s, jc.d_model)).astype(np.float32)
    jout, jcache = jax.jit(lambda p, a: JM.ssd_full(
        jc, jld, p, a, jnp.arange(s), 0, s))(jp, jnp.asarray(x))
    cache = {k: v[0].clone() for k, v in
             TM.init_cache(tc, B, s)["stages"]["s0"]["p0"].items()}
    h_addr, conv_addr = cache["h"].data_ptr(), cache["conv"].data_ptr()
    tout, same = TM.ssd_full(tc, ld, tp, _t(x), torch.arange(s), 0, cache)
    assert same is cache
    _close(tout.numpy(), jout)
    for k in ("h", "conv"):
        _close(cache[k].numpy(), jcache[k])
    for i in range(2):
        x1 = rng.standard_normal((B, jc.d_model)).astype(np.float32)
        pos = np.full((B,), s + i, np.int32)
        jout, jcache = jax.jit(lambda p, a, c, q: JM.ssd_decode(
            jc, jld, p, a, c, q))(jp, jnp.asarray(x1), jcache,
                                  jnp.asarray(pos))
        tout, _ = TM.ssd_decode(tc, ld, tp, _t(x1), cache, _t(pos))
        _close(tout.numpy(), jout)
        for k in ("h", "conv"):
            _close(cache[k].numpy(), jcache[k])
    assert (cache["h"].data_ptr(), cache["conv"].data_ptr()) == (h_addr,
                                                                 conv_addr)


# ---------------------------------------------------------------------------
# the model: prefill, decode_step, forward_hidden, the serve
# ---------------------------------------------------------------------------

def _same_caches(tcache, jcache):
    """Every layer's cache as JAX's: the SSD states and conv tails within
    1e-4 of max, the attention layer's packed K/V nibbles bit-equal
    (their scales within rtol 1e-6)."""
    for si, stage in _np(jcache)["stages"].items():
        for pi, layer in stage.items():
            mine = tcache["stages"][si][pi]
            for k, v in layer.items():
                if k in ("h", "conv"):
                    _close(mine[k].numpy(), v)
                elif k.endswith("_q"):
                    np.testing.assert_array_equal(mine[k].numpy(), v)
                else:
                    np.testing.assert_allclose(mine[k].numpy(), v,
                                               rtol=1e-6, atol=0)


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill and GEN - 1 decode steps fed JAX's tokens: logits within
    1e-4 of max |logit| at every step (finite), every layer's cache as
    JAX's after the prefill and after the last step; ``forward_hidden``
    within 1e-4 of max |h|."""
    tc, tokens, fns = model["tc"], model["tokens"], model["jax"]
    jlog, jcache = fns["prefill"](model["qp"],
                                  {"tokens": jnp.asarray(tokens)})
    tlog, tcache = TM.prefill(tc, model["tp"], {"tokens": _t(tokens)},
                              max_len=PROMPT + GEN)
    _close(tlog.numpy(), jlog)
    _same_caches(tcache, jcache)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for i in range(GEN - 1):
        pos = np.full((B,), PROMPT + i, np.int32)
        jlog, jcache = fns["decode"](model["qp"], jcache, jnp.asarray(tok),
                                     jnp.asarray(pos))
        tlog, tcache = TM.decode_step(tc, model["tp"], tcache, _t(tok),
                                      _t(pos))
        _close(tlog.numpy(), jlog)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    _same_caches(tcache, jcache)
    jh = fns["hidden"](model["qp"], {"tokens": jnp.asarray(tokens)})
    th = TM.forward_hidden(tc, model["tp"], {"tokens": _t(tokens)})
    _close(th.numpy(), jh)


def test_legacy_greedy_streams_match_jax(model):
    """``serve.legacy_serve`` and the port's ``make_serve_prefill``/
    ``make_serve_decode`` loop against JAX's jitted serve steps: the
    greedy streams identical."""
    tc, tokens, fns = model["tc"], model["tokens"], model["jax"]
    tok, cache = fns["serve_prefill"](model["qp"],
                                      {"tokens": jnp.asarray(tokens)})
    want = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, cache = fns["serve_decode"](
            model["qp"], cache, tok, jnp.full((B,), PROMPT + i, jnp.int32))
        want.append(np.asarray(tok))
    want = np.stack(want, 1).tolist()
    got = serve.legacy_serve(tc, model["tp"], tokens.tolist(), GEN, CPU)
    assert got["streams"] == want
    tpre = TS.make_serve_prefill(tc, PROMPT + GEN)
    tdec = TS.make_serve_decode(tc)
    tok, cache = tpre(model["tp"], {"tokens": _t(tokens)})
    loop = [tok]
    for i in range(GEN - 1):
        tok, cache = tdec(model["tp"], cache, tok,
                          torch.full((B,), PROMPT + i, dtype=torch.int32))
        loop.append(tok)
    assert torch.stack(loop, 1).tolist() == want


def test_decode_through_traced_runner(model):
    """The fixed-batch decode step on SSD states (and jamba's KV cache)
    through ``CompiledStep`` with the trace stand-in of a CUDA-graph
    capture (``FxGraph``: the capture's constraints, no host read):
    traced once, run at later inputs, logits and every state and cache
    tensor equal the eager step's."""
    tc, tp = model["tc"], model["tp"]
    g = torch.Generator().manual_seed(4)
    cache = fill_random(TM.init_cache(tc, 3, 16), g)
    calls = [(torch.randint(0, tc.vocab, (3,), generator=g,
                            dtype=torch.int32),
              torch.randint(0, 16, (3,), generator=g, dtype=torch.int32))
             for _ in range(4)]

    @torch.no_grad()
    def decode_logits(params, cache, token, pos):
        return TM.decode_step(tc, params, cache, token, pos)
    assert replay_vs_eager(CPU, ("legacy_decode", decode_logits, (tp, cache),
                                 calls), graph_type=FxGraph)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_legacy_and_refusal(arch, capsys):
    """``serve --arch <ssd arch> --smoke --legacy`` on the CPU prints its
    streams and the closing report; without ``--legacy`` it exits as the
    JAX serve does, naming the ssd mixer."""
    r = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--legacy", "--batch", "2", "--prompt-len", "12",
                    "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated 2 x 3 tokens" in out
    assert "MSB4 sub-precision sparsity of hidden activations" in out
    assert [len(s) for s in r["streams"]] == [3, 3]
    assert 0 < r["hidden_sparsity"] < 1
    with pytest.raises(SystemExit, match=r"mixer='ssd'.*\n\(this arch "
                                         r"serves via --legacy only\)"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])

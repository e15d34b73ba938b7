"""Port parity, the gemma family on the fixed-batch path (``serve
--legacy``): gemma3-27b (5 sliding-window layers to 1 global, the
global ones at rope theta 1e6; qk-norm; GeGLU; tied head) and
paligemma-3b (a bidirectional prefix of stub image patches; GeGLU;
KVH 1). Same numpy inputs (tokens, patches, caches), JAX's quantized
tree converted, CPU plain versions; the smoke configs at f32, as the
other archs' stream tests run (``tests/test_torch_zoo.py``).

Tolerances: attention within 1e-5 in f32 (the plain versions sum in
other orders than XLA's block loops); the GeGLU FFN within rtol 4e-6,
atol 1e-6 at f32 (XLA's tanh is not torch's) and bit-equal at bf16
(both round each op); logits within 1e-4; the greedy streams identical,
with prompts long enough that the smoke window (16) binds in the
prefill and in every decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_27b as jgemma3
from repro.configs import paligemma_3b as jpaligemma
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_numpy_tree, to_tensor
from repro_torch.core.qlinear import tree_index
from repro_torch.kernels import kv_attention as tkv
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.schema import _map_schema
from repro_torch.models.schema_builder import build_schema as tschema
from repro_torch.models.stages import build_stages

JCONFIGS = {"gemma3-27b": jgemma3, "paligemma-3b": jpaligemma}
ARCHS = tuple(JCONFIGS)
RTOL, ATOL = 4e-6, 1e-6
LOGIT_ATOL = 1e-4
GEN = 6
# prompt tokens (gemma3: past the smoke window of 16; paligemma: after
# its 4 patches)
PROMPT = {"gemma3-27b": 24, "paligemma-3b": 20}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jconfig(arch):
    return JCONFIGS[arch].SMOKE.replace(dtype="float32")


def tconfig(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _randomize_norms(params, rng):
    """Every norm gain (the qk-norms too) drawn non-zero, so that the
    gains' (1 + g) scaling is exercised and must cross over."""
    if isinstance(params, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.5,
                                jnp.float32)
                    if k in ("gamma", "q_norm", "k_norm") else
                    _randomize_norms(v, rng)) for k, v in params.items()}
    return params


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """JAX config and quantized tree, the port's config and conversion,
    the prompts (B=2) and, for paligemma, the patches."""
    arch = request.param
    jc = jconfig(arch)
    rng = np.random.default_rng(3)
    floats = _randomize_norms(jinit(jschema(jc), jax.random.PRNGKey(0)),
                              rng)
    qp = jquantize(floats, w_bits=4, k_percent=50.0, clip_l=-8.0,
                   clip_h=23.0, enable_clipping=True, tile_k=16)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, PROMPT[arch])).astype(
        np.int32)}
    if jc.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, jc.n_prefix, jc.d_model)).astype(np.float32)
    return dict(arch=arch, jc=jc, tc=tconfig(jc), qp=qp,
                tp=convert_tree(_np(qp)), batch=batch)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and schemas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_stages_match_jax(arch, smoke):
    from repro.models.stages import build_stages as jstages
    jmod = JCONFIGS[arch]
    jc = jmod.SMOKE if smoke else jmod.CONFIG
    tc = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)

    def plan(stages):
        return [([dataclasses.asdict(ld) for ld in st.period], st.repeat)
                for st in stages]
    assert plan(build_stages(tc)) == plan(jstages(jc))


def test_gemma3_stage_plan():
    """62 layers: ten periods of 5 local (window 1024) + 1 global (window
    0, rope theta 1e6) layers, then a tail of 2 local layers."""
    stages = build_stages(get_config("gemma3-27b"))
    assert [(len(s.period), s.repeat) for s in stages] == [(6, 10), (2, 1)]
    assert [ld.window for ld in stages[0].period] == [1024] * 5 + [0]
    assert stages[0].period[-1].rope_theta == 1e6
    assert [ld.window for ld in stages[1].period] == [1024, 1024]
    assert sum(s.n_layers for s in stages) == 62


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_matches_jax(arch):
    """Every leaf path, shape and init of the port's schema = JAX's (the
    GeGLU leaves and gemma3's q_norm/k_norm among them)."""
    jc = JCONFIGS[arch].SMOKE
    mine, theirs = {}, {}
    _map_schema(tschema(tconfig(jc)),
                lambda p, s: mine.__setitem__(p, (s.shape, s.init, s.scale)))
    jflat = jax.tree_util.tree_flatten_with_path(
        jschema(jc), is_leaf=lambda x: hasattr(x, "init"))[0]
    for path, s in jflat:
        theirs["/".join(k.key for k in path)] = (tuple(s.shape), s.init,
                                                 s.scale)
    assert mine == theirs
    assert ("stages/s0/p0/q_norm" in mine) == (arch == "gemma3-27b")
    assert {"stages/s0/p0/w_gate", "stages/s0/p0/w_up",
            "stages/s0/p0/w_down"} <= set(mine)


def test_convert_tree_carries_qk_norms_and_geglu(model):
    jp = _np(model["qp"])["stages"]["s0"]["p0"]
    tp = model["tp"]["stages"]["s0"]["p0"]
    names = ("q_norm", "k_norm") if model["arch"] == "gemma3-27b" else ()
    for name in names:
        assert np.any(jp[name] != 0)
        np.testing.assert_array_equal(tp[name].numpy(), jp[name])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tp[name].w.q.numpy(),
                                      np.asarray(jp[name].w.q))


# ---------------------------------------------------------------------------
# the masks: flash attention with a window or a prefix, windowed decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,prefix,bq,bkv", [
    (8, 0, 16, 16),       # a window inside a block
    (20, 0, 16, 16),      # a window across block edges
    (33, 0, 16, 32),      # longer than a kv block, not a multiple of one
    (0, 4, 16, 16),       # a prefix inside the first block
    (0, 24, 16, 16),      # a prefix across a block edge
    (12, 24, 32, 16),     # both (JAX's mask: (causal | prefix) & window)
])
def test_flash_attention_window_and_prefix_match_jax(window, prefix, bq,
                                                     bkv):
    rng = np.random.default_rng(window + 7 * prefix)
    q = rng.standard_normal((2, 64, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)),
                              JL.AttnSpec(window=window, prefix_len=prefix),
                              bq=bq, bkv=bkv)
    got = TL.flash_attention(_t(q), _t(k), _t(v),
                             TL.AttnSpec(window=window, prefix_len=prefix),
                             bq=bq, bkv=bkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _kv4_cache(seed, b, s, kvh, hd):
    rng = np.random.default_rng(seed)
    kq, vq = (rng.integers(-128, 128, (b, s, kvh, hd // 2)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.1, 1.0, (b, s, kvh)).astype(np.float32)
              for _ in range(2))
    return kq, ks, vq, vs


@pytest.mark.parametrize("window", [1, 15, 16, 17, 23, 64, 200])
def test_windowed_decode_attention_matches_jax(window):
    """``layers.decode_attention`` on the dequantized cache and row 7's
    plain version on the packed one (the wrapper's CPU path) against
    JAX's ``decode_attention`` over ``_kv_dequant``'s cache, windows of
    1, a block +- 1, not a multiple of one, and wider than every pos
    (which gives window 0's bits)."""
    b, s, kvh, g, hd = 4, 64, 2, 2, 16
    kq, ks, vq, vs = _kv4_cache(window, b, s, kvh, hd)
    jc = jconfig("gemma3-27b")
    k = JM._kv_dequant(jc, jnp.asarray(kq), jnp.asarray(ks), jnp.float32)
    v = JM._kv_dequant(jc, jnp.asarray(vq), jnp.asarray(vs), jnp.float32)
    q = np.random.default_rng(window + 1).standard_normal(
        (b, kvh * g, hd)).astype(np.float32)
    pos = np.array([0, 20, 37, s - 1], np.int32)
    want = np.asarray(JL.decode_attention(jnp.asarray(q), k, v,
                                          jnp.asarray(pos),
                                          JL.AttnSpec(window=window)))
    plain = TL.decode_attention(_t(q), _t(np.asarray(k)), _t(np.asarray(v)),
                                _t(pos), TL.AttnSpec(window=window))
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=0)
    packed = [_t(x) for x in (kq, ks, vq, vs)]
    qg = _t(q).reshape(b, kvh, g, hd)
    for got in (ref.kv4_decode_attention_ref(qg, *packed, _t(pos),
                                             window=window),
                tkv.kv4_decode_attention(qg, *packed, _t(pos),
                                         window=window)):
        np.testing.assert_allclose(got.reshape(b, kvh * g, hd).numpy(), want,
                                   atol=1e-5, rtol=0)
    if window >= s:
        assert torch.equal(got, tkv.kv4_decode_attention(qg, *packed,
                                                         _t(pos)))


# ---------------------------------------------------------------------------
# the GeGLU FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_dense_ffn_matches_jax(dtype):
    jc = jgemma3.SMOKE.replace(dtype=dtype)
    floats = _randomize_norms(jinit(jschema(jc), jax.random.PRNGKey(1)),
                              np.random.default_rng(4))
    qp = jquantize(floats, w_bits=4, k_percent=50.0, clip_l=-8.0,
                   clip_h=23.0, enable_clipping=True, tile_k=16)
    tp = convert_tree(_np(qp))
    jp = jax.tree_util.tree_map(lambda x: x[0], qp["stages"]["s0"]["p0"])
    tpp = tree_index(tp["stages"]["s0"]["p0"], 0)
    x = np.random.default_rng(5).standard_normal((2, 5, jc.d_model)) * 2
    xj = jnp.asarray(x, jnp.float32).astype(jc.cdtype)
    got = TM.dense_ffn(tconfig(jc), tpp, to_tensor(xj)).float().numpy()
    want = np.asarray(JM.dense_ffn(jc, jp, xj).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the model: prefill, decode_step, forward_hidden
# ---------------------------------------------------------------------------

def test_embed_inputs_match_jax(model):
    jx, _, jprefix = JM.embed_inputs(model["jc"], model["qp"],
                                     _jbatch(model["batch"]))
    tx, tpos, tprefix = TM.embed_inputs(model["tc"], model["tp"],
                                        _tbatch(model["batch"]))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tprefix == jprefix == model["jc"].n_prefix
    assert tpos.tolist() == list(range(jx.shape[1]))


def test_forward_hidden_matches_jax(model):
    want = np.asarray(JM.forward_hidden(model["jc"], model["qp"],
                                        _jbatch(model["batch"])))
    got = TM.forward_hidden(model["tc"], model["tp"], _tbatch(model["batch"]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill (logits and caches) and GEN - 1 decode steps fed JAX's
    tokens: logits within LOGIT_ATOL at every step."""
    jc, tc, batch = model["jc"], model["tc"], model["batch"]
    s = batch["tokens"].shape[1] + jc.n_prefix
    max_len = s + GEN
    jlog, jcache = jax.jit(lambda p, bt: JM.prefill(jc, p, bt,
                                                    max_len=max_len))(
        model["qp"], _jbatch(batch))
    tlog, tcache = TM.prefill(tc, model["tp"], _tbatch(batch),
                              max_len=max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    jc0 = _np(jcache)["stages"]["s0"]["p0"]
    tc0 = to_numpy_tree(tcache)["stages"]["s0"]["p0"]
    np.testing.assert_array_equal(tc0["k_q"], jc0["k_q"])
    jdecode = jax.jit(lambda p, c, t, q: JM.decode_step(jc, p, c, t, q))
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for i in range(GEN - 1):
        pos = np.full((2,), s + i, np.int32)
        jlog, jcache = jdecode(model["qp"], jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        tlog, tcache = TM.decode_step(tc, model["tp"], tcache, _t(tok),
                                      _t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)


def test_legacy_greedy_streams_match_jax(model):
    """The port's ``make_serve_prefill``/``make_serve_decode`` loop and
    ``serve.legacy_serve`` against JAX's jitted steps: identical greedy
    streams (gemma3: the 24-token prompt passes the window of 16, so it
    binds in the prefill and in every decode step)."""
    jc, tc, batch = model["jc"], model["tc"], model["batch"]
    plen = batch["tokens"].shape[1] + jc.n_prefix
    jpre = jax.jit(JS.make_serve_prefill(jc, plen + GEN))
    jdec = jax.jit(JS.make_serve_decode(jc))
    tok, cache = jpre(model["qp"], _jbatch(batch))
    want = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, cache = jdec(model["qp"], cache, tok,
                          jnp.full((2,), plen + i, jnp.int32))
        want.append(np.asarray(tok))
    want = np.stack(want, 1).tolist()
    patches = _t(batch["patches"]) if "patches" in batch else None
    got = serve.legacy_serve(tc, model["tp"], batch["tokens"].tolist(), GEN,
                             torch.device("cpu"), patches)
    assert got["streams"] == want
    tpre = TS.make_serve_prefill(tc, plen + GEN)
    tdec = TS.make_serve_decode(tc)
    tok, cache = tpre(model["tp"], _tbatch(batch))
    loop = [tok]
    for i in range(GEN - 1):
        tok, cache = tdec(model["tp"], cache, tok,
                          torch.full((2,), plen + i, dtype=torch.int32))
        loop.append(tok)
    assert torch.stack(loop, 1).tolist() == want


# ---------------------------------------------------------------------------
# the support checks and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,why", [("gemma3-27b", "window=1024"),
                                      ("paligemma-3b", "got vlm")])
def test_paged_path_refuses_and_contiguous_accepts(arch, why):
    cfg = get_config(arch)
    TM.check_contiguous_support(cfg)
    with pytest.raises(NotImplementedError, match=why):
        TM.check_paged_support(cfg)
    for bad, name in ((cfg.replace(family="encoder"), "encoder"),
                      (cfg.replace(kv_bits=8), "kv_bits=4")):
        with pytest.raises(NotImplementedError, match=name):
            TM.check_contiguous_support(bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_legacy_and_refusal(arch, capsys):
    """``serve --legacy --smoke`` on the CPU (both archs), and without
    ``--legacy`` the JAX serve's exit: the window or the VLM named, then
    "(this arch serves via --legacy only)"."""
    r = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--legacy", "--batch", "2", "--prompt-len", "24",
                    "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated 2 x 3 tokens" in out
    assert "MSB4 sub-precision sparsity of hidden activations" in out
    assert [len(s) for s in r["streams"]] == [3, 3]
    assert 0 < r["hidden_sparsity"] < 1
    with pytest.raises(SystemExit,
                       match=r"(window=16\)|got vlm)\n\(this arch serves "
                             r"via --legacy only\)"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_serve_cli_vlm_prompt_must_pass_the_prefix():
    with pytest.raises(SystemExit, match="image-prefix"):
        serve.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu",
                    "--legacy", "--prompt-len", "4"])

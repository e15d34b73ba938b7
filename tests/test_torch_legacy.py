"""Port parity, the contiguous (fixed-batch, ``serve --legacy``) path:
the float attention of ``models/layers.py``, the contiguous KV4 decode
attention's plain version, the contiguous ``prefill``/``decode_step``
and their step closures, and greedy streams, against the JAX package on
the same numpy inputs and against the port's own paged engine (CPU,
plain versions; JAX's kernels in interpret mode).

Tolerances: attention within 1e-5 in f32 (the plain versions sum in
other orders than XLA's block loops and the Pallas kernel's online
softmax); logits within 1e-4 (f32); cache nibbles exact, cache scales
within 1e-6 relative (an ulp of RoPE can move a K/V row's absmax, as in
``test_torch_model.py``); paged and contiguous attention on the same
cache bit-exact; greedy streams identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.kernels.kv_attention import kv4_decode_attention as jkv4_decode
from repro.launch import steps as JS
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_numpy_tree
from repro_torch.kernels import kv_attention as tkv
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig)

CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def qparams():
    return jquantize(jinit(jschema(CFG), jax.random.PRNGKey(0)), w_bits=4,
                     k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     enable_clipping=True, tile_k=16)


@pytest.fixture(scope="module")
def tparams(qparams):
    return convert_tree(_np(qparams))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _cache(seed, b, s, kvh, hd):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-128, 128, (b, s, kvh, hd // 2)).astype(np.int8)
    vq = rng.integers(-128, 128, (b, s, kvh, hd // 2)).astype(np.int8)
    ks = rng.uniform(0.1, 1.0, (b, s, kvh)).astype(np.float32)
    vs = rng.uniform(0.1, 1.0, (b, s, kvh)).astype(np.float32)
    return kq, ks, vq, vs


def test_flash_attention_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    spec = jlayers.AttnSpec(causal=True)
    want = jlayers.flash_attention(*map(jnp.asarray, (q, k, v)), spec,
                                   bq=16, bkv=32)
    got = tlayers.flash_attention(_t(q), _t(k), _t(v), tlayers.AttnSpec(),
                                  bq=16, bkv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    whole = tlayers.flash_attention(_t(q), _t(k), _t(v), tlayers.AttnSpec())
    np.testing.assert_allclose(whole.numpy(), got.numpy(), atol=1e-5, rtol=0)
    # the bidirectional (encoder) spec, alone and with a window
    for kw in (dict(window=8), dict(prefix_len=4), dict(causal=False),
               dict(causal=False, window=8)):
        want = jlayers.flash_attention(*map(jnp.asarray, (q, k, v)),
                                       jlayers.AttnSpec(**kw), bq=16, bkv=32)
        got = tlayers.flash_attention(_t(q), _t(k), _t(v),
                                      tlayers.AttnSpec(**kw), bq=16, bkv=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_contiguous_attention_plain_matches_jax():
    """Row 7's plain version (and ``layers.decode_attention`` on the
    dequantized cache) against the Pallas ``kv4_decode_attention``."""
    b, s, kvh, g, hd, bs = 3, 64, 2, 2, 16, 16
    kq, ks, vq, vs = _cache(1, b, s, kvh, hd)
    q = np.random.default_rng(2).standard_normal((b, kvh, g, hd)).astype(
        np.float32)
    pos = np.array([0, 17, s - 1], np.int32)
    want = np.asarray(jkv4_decode(*map(jnp.asarray, (q, kq, ks, vq, vs,
                                                       pos)),
                                  bs=bs, interpret=True))
    got = tkv.kv4_decode_attention(*map(_t, (q, kq, ks, vq, vs, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    deq = lambda p, sc: ref.unpack_kv4(_t(p)).float() * _t(sc)[..., None]  # noqa: E731
    plain = tlayers.decode_attention(
        _t(q).reshape(b, kvh * g, hd), deq(kq, ks), deq(vq, vs), _t(pos),
        tlayers.AttnSpec())
    np.testing.assert_allclose(plain.reshape(b, kvh, g, hd).numpy(), want,
                               atol=1e-5, rtol=0)
    jplain = jlayers.decode_attention(
        jnp.asarray(q).reshape(b, kvh * g, hd), jnp.asarray(deq(kq, ks)),
        jnp.asarray(deq(vq, vs)), jnp.asarray(pos), jlayers.AttnSpec())
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("b,s,kvh,g,hd,ps", [(2, 64, 2, 4, 32, 16),
                                             (1, 48, 1, 2, 16, 8)])
def test_paged_attention_bitexact_vs_contiguous(b, s, kvh, g, hd, ps):
    """The cache tiled into shuffled pages of ``ps`` tokens: the paged
    attention gives the contiguous one's bits (``tests/test_serving.py``'s
    contract, on the plain versions)."""
    kq, ks, vq, vs = _cache(3, b, s, kvh, hd)
    q = np.random.default_rng(4).standard_normal((b, kvh, g, hd)).astype(
        np.float32)
    pos = np.random.default_rng(5).integers(1, s, b).astype(np.int32)
    n_per = s // ps
    perm = np.random.RandomState(0).permutation(b * n_per) + 1
    pages = [np.zeros((b * n_per + 1, ps) + a.shape[2:], a.dtype)
             for a in (kq, ks, vq, vs)]
    bt = np.zeros((b, n_per), np.int32)
    for i in range(b):
        for j in range(n_per):
            bt[i, j] = pid = perm[i * n_per + j]
            for dst, src in zip(pages, (kq, ks, vq, vs)):
                dst[pid] = src[i, j * ps:(j + 1) * ps]
    contiguous = tkv.kv4_decode_attention(*map(_t, (q, kq, ks, vq, vs, pos)),
                                          bs=ps)
    paged = tkv.kv4_paged_decode_attention(_t(q), *map(_t, pages), _t(bt),
                                           _t(pos))
    assert torch.equal(contiguous, paged)


# ---------------------------------------------------------------------------
# the model's contiguous entry points
# ---------------------------------------------------------------------------

def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)).astype(
        np.int32)


def test_prefill_and_decode_step_match_jax(qparams, tparams):
    b, s, max_len = 2, 12, 16
    toks = _tokens(0, b, s)
    jl, jcache = JM.prefill(CFG, qparams, {"tokens": jnp.asarray(toks)},
                            max_len=max_len)
    tl, tcache = TM.prefill(TCFG, tparams, {"tokens": _t(toks)},
                            max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    token = np.array([5, 77], np.int32)
    for step in range(3):
        pos = np.full((b,), s + step, np.int32)
        jl, jcache = JM.decode_step(CFG, qparams, jcache, jnp.asarray(token),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(TCFG, tparams, tcache, _t(token), _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        token = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jc = _np(jcache)["stages"]["s0"]["p0"]
    tc = to_numpy_tree(tcache)["stages"]["s0"]["p0"]
    assert tc["k_q"].shape == (CFG.n_layers, b, max_len, 2, 4)
    for key in ("k_q", "v_q"):
        np.testing.assert_array_equal(tc[key], jc[key])
    for key in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=1e-6, atol=0)
    assert (tc["k_q"][:, :, :s + 3] != 0).any()
    assert (tc["k_q"][:, :, s + 3:] == 0).all()


def test_forward_matches_jax_and_prefill(qparams, tparams):
    toks = _tokens(1, 2, 8)
    want = np.asarray(JM.forward(CFG, qparams, {"tokens": jnp.asarray(toks)}))
    got = TM.forward(TCFG, tparams, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    last, _ = TM.prefill(TCFG, tparams, {"tokens": _t(toks)}, max_len=8)
    np.testing.assert_array_equal(last.numpy(), got[:, -1].numpy())


def test_contiguous_path_serves_windowed_layers_as_jax(qparams, tparams):
    """A sliding window of 4 on the same weights: the contiguous path's
    prefill (the window binding inside the 10-token prompt) and decode
    steps give JAX's logits and greedy tokens; the paged path still
    refuses the window, as JAX's does."""
    jcfg, cfg = CFG.replace(sliding_window=4), TCFG.replace(sliding_window=4)
    with pytest.raises(NotImplementedError, match="full-attention"):
        TM.check_paged_support(cfg)
    toks = _tokens(2, 2, 10)
    jlog, jcache = JM.prefill(jcfg, qparams, {"tokens": jnp.asarray(toks)},
                              max_len=14)
    tlog, tcache = TM.prefill(cfg, tparams, {"tokens": _t(toks)}, max_len=14)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    for i in range(3):
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        pos = np.full((2,), 10 + i, np.int32)
        jlog, jcache = JM.decode_step(jcfg, qparams, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        tlog, tcache = TM.decode_step(cfg, tparams, tcache, _t(tok), _t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                                   rtol=0)
        assert (np.argmax(tlog.numpy(), -1) ==
                np.argmax(np.asarray(jlog), -1)).all()


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


PROMPTS = [(12, 6), (20, 5), (5, 6), (30, 4)]


def test_legacy_streams_match_jax_and_engine(qparams, tparams):
    """Per prompt: the port's fixed-batch greedy stream = JAX's (its
    ``make_serve_*`` steps) = the port's paged engine with the prefill
    unchunked (``tests/test_serving.py``'s contract); the port's stream
    through the prefill into caches made outside it too."""
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(0, CFG.vocab, n).tolist(), g)
               for n, g in PROMPTS]
    eng = Engine(TCFG, tparams, pool_config=PoolConfig(n_pages=64,
                                                       page_size=8),
                 sched_config=SchedulerConfig(
                     max_decode_batch=2, token_budget=256, prefill_chunk=32,
                     max_pages_per_seq=8), device="cpu")
    handles = [eng.submit(p, SamplingParams(max_new_tokens=g))
               for p, g in prompts]
    eng.run()
    for (p, g), h in zip(prompts, handles):
        jstream = _legacy_greedy(
            jax.jit(JS.make_serve_prefill(CFG, len(p) + g)),
            jax.jit(JS.make_serve_decode(CFG)), qparams, p, g, jnp.asarray)
        tstream = _legacy_greedy(TS.make_serve_prefill(TCFG, len(p) + g),
                                 TS.make_serve_decode(TCFG), tparams, p, g,
                                 _t)
        assert tstream == jstream
        assert tstream == list(h.out_tokens)
        assert _legacy_greedy(prefill_into(TCFG, len(p) + g),
                              TS.make_serve_decode(TCFG), tparams, p, g,
                              _t) == jstream


def test_legacy_serve_batch_and_flags(tparams, capsys):
    prompts = _tokens(9, 3, 10).tolist()
    r = serve.legacy_serve(TCFG, tparams, prompts, 4, torch.device("cpu"))
    assert r["decode_steps"] == 3
    for p, stream in zip(prompts, r["streams"]):
        assert stream == _legacy_greedy(
            TS.make_serve_prefill(TCFG, 14), TS.make_serve_decode(TCFG),
            tparams, p, 4, _t)
    serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                "--legacy", "--batch", "2", "--prompt-len", "12", "--gen",
                "3"])
    assert "generated 2 x 3 tokens" in capsys.readouterr().out
    for flag in ("--metrics-out", "--trace-out"):
        with pytest.raises(SystemExit, match="--legacy"):
            serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                        "--legacy", flag, "out.json"])

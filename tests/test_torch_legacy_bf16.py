"""Port parity of the fixed-batch (``serve --legacy``) path at bf16.

JAX's ``attn_decode`` dequantizes the packed KV4 cache into the
activation dtype (``_kv_dequant(..., x.dtype)``) before its f32
attention, so at bf16 every K and V element is rounded to bf16 first.
The port's contiguous decode does the same through
``kv4_decode_attention(round_kv=True)``. Same numpy inputs and the same
quantized weights (JAX's tree, converted) on both sides, CPU, plain
versions.

The decode tests start from JAX's prefill cache on both sides. The
prefill itself is held op by op, each on the same bf16 input as JAX's
(``attn_full`` within one bf16 ulp, ``dense_ffn`` bit-equal): XLA's CPU
compiler fuses a whole jitted layer and feeds the unrounded f32
residual sum into the FFN's norm (excess precision), which an eager
bf16 program cannot reproduce op for op; after a few layers that moves
some int8 roundings of the cache by one step.

Tolerances: attention output within one bf16 ulp (2^-7 relative to the
output's magnitude, floor 1: both sides round one f32 result, summed in
different orders, to bf16); decode logits within one bf16 ulp element
by element, same argmax; greedy streams identical. ``round_kv=False``
keeps the plain version as it was (f32 dequant).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.kernels import kv_attention as tkv
from repro_torch.kernels import ref
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM

CFG = JConfig(name="tiny-serve-bf16", family="transformer", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab=128, dtype="bfloat16")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
ULP = 2.0 ** -7


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.fixture(scope="module")
def qparams():
    return jquantize(jinit(jschema(CFG), jax.random.PRNGKey(1)), w_bits=4,
                     k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     enable_clipping=True, tile_k=16)


@pytest.fixture(scope="module")
def tparams(qparams):
    return convert_tree(jax.tree_util.tree_map(np.asarray, qparams))


def _layer(params, i=0):
    return jax.tree_util.tree_map(lambda a: a[i],
                                  params["stages"]["s0"]["p0"])


def _torch_layer(params, i=0):
    from repro_torch.core.qlinear import tree_index
    return tree_index(params["stages"]["s0"]["p0"], i)


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp of |want| (floor 1)."""
    scale = np.maximum(np.abs(want), 1.0)
    return np.abs(got - want) / (ULP * scale)


def _cache(seed, b, s):
    rng = np.random.default_rng(seed)
    kvh, hp = CFG.n_kv_heads, CFG.head_dim // 2
    return {"k_q": rng.integers(-128, 128, (b, s, kvh, hp)).astype(np.int8),
            "k_s": rng.uniform(0.01, 0.3, (b, s, kvh)).astype(np.float32),
            "v_q": rng.integers(-128, 128, (b, s, kvh, hp)).astype(np.int8),
            "v_s": rng.uniform(0.01, 0.3, (b, s, kvh)).astype(np.float32)}


def test_attn_decode_matches_jax_at_bf16(qparams, tparams):
    """One layer's ``attn_decode`` on the same bf16 x and cache: within
    one bf16 ulp of JAX's, cache bytes equal."""
    b, s = 3, 32
    from repro.models.stages import build_stages as jstages
    from repro_torch.models.stages import build_stages as tstages
    jld = jstages(CFG)[0].period[0]
    tld = tstages(TCFG)[0].period[0]
    x = np.random.default_rng(0).standard_normal((b, CFG.d_model)).astype(
        np.float32)
    pos = np.array([0, 13, s - 1], np.int32)
    cache = _cache(1, b, s)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jo, jc = JM.attn_decode(CFG, jld, _layer(qparams), jx,
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(pos))
    tc = {k: _t(v) for k, v in cache.items()}
    to, tc = TM.attn_decode(TCFG, tld, _torch_layer(tparams),
                            _t(x).to(torch.bfloat16), tc, _t(pos))
    assert to.dtype == torch.bfloat16
    assert (_bf16_ulps(to.float().numpy(), _f32(jo)) <= 1).all()
    for key in ("k_q", "v_q"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


def test_attn_full_matches_jax_at_bf16(qparams, tparams):
    """The prefill attention at bf16 (no KV dequant on this path: it
    attends over the unquantized bf16 K/V, as JAX's does)."""
    from repro.models.stages import build_stages as jstages
    from repro_torch.models.stages import build_stages as tstages
    jld = jstages(CFG)[0].period[0]
    tld = tstages(TCFG)[0].period[0]
    b, s = 2, 24
    x = np.random.default_rng(2).standard_normal((b, s, CFG.d_model)).astype(
        np.float32)
    positions = np.arange(s, dtype=np.int32)
    jo, _ = JM.attn_full(CFG, jld, _layer(qparams),
                         jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(positions), 0, None)
    to, _ = TM.attn_full(TCFG, tld, _torch_layer(tparams),
                         _t(x).to(torch.bfloat16), _t(positions), 0, None)
    assert (_bf16_ulps(to.float().numpy(), _f32(jo)) <= 1).all()


def test_dense_ffn_matches_jax_at_bf16(qparams, tparams):
    """The FFN at bf16: silu op by op, each rounded to bf16 as
    ``jax.nn.silu``'s ops are, gives JAX's bits."""
    x = np.random.default_rng(6).standard_normal((2, 24, CFG.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    want = _f32(JM.dense_ffn(CFG, _layer(qparams), jx))
    got = TM.dense_ffn(TCFG, _torch_layer(tparams), _t(jx))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)).astype(
        np.int32)


def _to_torch_cache(jcache):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  jcache)


def test_decode_step_logits_match_jax_at_bf16(qparams, tparams):
    """Three decode steps from the same cache (JAX's prefill's): logits
    within one bf16 ulp of JAX's, element by element, same argmax."""
    b, s, max_len = 2, 12, 16
    toks = _tokens(3, b, s)
    _, jcache = JM.prefill(CFG, qparams, {"tokens": jnp.asarray(toks)},
                           max_len=max_len)
    tcache = _to_torch_cache(jcache)
    token = np.array([5, 77], np.int32)
    for step in range(3):
        pos = np.full((b,), s + step, np.int32)
        jl, jcache = JM.decode_step(CFG, qparams, jcache, jnp.asarray(token),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(TCFG, tparams, tcache, _t(token), _t(pos))
        want, got = _f32(jl), tl.float().numpy()
        assert (_bf16_ulps(got, want) <= 1).all(), step
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        token = want.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("n,gen", [(12, 8), (20, 6), (5, 8)])
def test_legacy_streams_match_jax_at_bf16(qparams, tparams, n, gen):
    """Greedy ``--legacy`` decoding after JAX's prefill: the port's
    decode steps (``make_serve_decode``) give JAX's jitted stream."""
    prompt = np.random.default_rng(n).integers(0, CFG.vocab, n).tolist()
    tok, jcache = jax.jit(JS.make_serve_prefill(CFG, n + gen))(
        qparams, {"tokens": jnp.asarray([prompt], jnp.int32)})
    tcache = _to_torch_cache(jcache)
    jdecode, tdecode = jax.jit(JS.make_serve_decode(CFG)), \
        TS.make_serve_decode(TCFG)
    jstream, tstream = [int(tok[0])], [int(tok[0])]
    for i in range(gen - 1):
        pos = np.full((1,), n + i, np.int32)
        jt, jcache = jdecode(qparams, jcache,
                             jnp.asarray([jstream[-1]], jnp.int32),
                             jnp.asarray(pos))
        tt, tcache = tdecode(tparams, tcache,
                             _t(np.asarray([tstream[-1]], np.int32)),
                             _t(pos))
        jstream.append(int(jt[0]))
        tstream.append(int(tt[0]))
    assert tstream == jstream


def test_round_kv_false_keeps_the_contiguous_plain_version():
    """The default reads K and V in f32 (the Pallas contract): the plain
    version equals f32 attention over the f32-dequantized cache, and
    ``round_kv`` changes nothing at f32."""
    b, s, kvh, g, hd = 3, 48, 2, 2, 16
    c = {k: _t(v) for k, v in _cache(4, b, s).items()}
    rng = np.random.default_rng(5)
    pos = _t(np.array([0, 17, s - 1], np.int32))
    args = (c["k_q"], c["k_s"], c["v_q"], c["v_s"], pos)
    k = ref.unpack_kv4(c["k_q"]).float() * c["k_s"][..., None]
    v = ref.unpack_kv4(c["v_q"]).float() * c["v_s"][..., None]
    for dt in (torch.float32, torch.bfloat16):
        q = _t(rng.standard_normal((b, kvh, g, hd)).astype(np.float32)).to(dt)
        got = tkv.kv4_decode_attention(q, *args)
        assert torch.equal(got, ref.decode_attention_f32(q, k, v, pos))
        assert torch.equal(got, ref.kv4_decode_attention_ref(
            q, *args, round_kv=False))
    q = _t(rng.standard_normal((b, kvh, g, hd)).astype(np.float32))
    assert torch.equal(tkv.kv4_decode_attention(q, *args, round_kv=True),
                       tkv.kv4_decode_attention(q, *args))
    qb = q.to(torch.bfloat16)
    assert not torch.equal(tkv.kv4_decode_attention(qb, *args, round_kv=True),
                           tkv.kv4_decode_attention(qb, *args))

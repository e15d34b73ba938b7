"""Port parity, deepseek-v3-671b on the fixed-batch path (``serve
--legacy``): MLA in its weight-absorbed form on a packed-int4 compressed
KV cache, 256-expert sigmoid routing after leading dense layers, the
untied head and the MTP block. Same numpy inputs, JAX's quantized tree
converted (``convert.py``), CPU plain versions; the SMOKE config cut to
2 layers (one dense, one MoE) at f32, as the other archs' parity tests
run. Each JAX function is jitted once a module (its smoke compiles are
the slow part of this file).

Tolerances: integer work bit-equal (the dequantized ``wkv_b``, the
packed cache bytes and scales, the chunked expert quantization); the MLA
attention (blockwise and decode) within 1e-4 of max |out| in f32 (the
plain einsums sum in other orders than XLA's); the MLA projections within
rtol 1e-5; logits and MTP logits within 1e-4 of max |logit|; the greedy
streams identical.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as jv3
from repro.core.qlinear import quantize_leaf as jquantize_leaf
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.registry import cache_schema as jcache_schema
from repro.models.schema import init_params as jinit
from repro.models.schema import param_count as jparam_count
from repro.models.schema_builder import build_schema as jschema
from repro.models.stages import LayerDef as JLayerDef
from repro.models.stages import build_stages as jstages
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_tensor
from repro_torch.core import qlinear as tql
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema_mod
from repro_torch.models.schema import _map_schema
from repro_torch.models.schema_builder import build_schema as tschema
from repro_torch.models.stages import LayerDef, build_stages

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graphs import FxGraph  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_random, replay_vs_eager  # noqa: E402

ARCH = "deepseek-v3-671b"
MLA_TOL = 1e-4          # of max |out|
LOGIT_TOL = 1e-4        # of max |logit|
PROJ_RTOL, PROJ_ATOL = 1e-5, 1e-6
PROMPT, GEN, B = 20, 6, 2
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jconfig():
    """SMOKE cut to one dense and one MoE layer, f32."""
    return jv3.SMOKE.replace(n_layers=2, first_dense=1, dtype="float32")


def tconfig(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _randomize_norms(params, rng):
    """Every norm gain (MLA's q_norm and kv_norm, MTP's norm_h/norm_e
    too) drawn non-zero, so that the (1 + g) scaling must cross over."""
    if isinstance(params, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.5,
                                jnp.float32)
                    if k in ("gamma", "q_norm", "kv_norm") else
                    _randomize_norms(v, rng)) for k, v in params.items()}
    return params


def _close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def model():
    """JAX's config and quantized tree (norms randomized), the port's
    config and conversion, and the prompts."""
    jc = jconfig()
    rng = np.random.default_rng(3)
    floats = _randomize_norms(jinit(jschema(jc), jax.random.PRNGKey(0)), rng)
    # jitted: a fifth of the eager conversion's time (XLA's scales may
    # differ from the eager ones by an ulp; both packages read these)
    qp = jax.jit(lambda f: jquantize(f, w_bits=4, k_percent=50.0,
                                     clip_l=-8.0, clip_h=23.0,
                                     enable_clipping=True, tile_k=16))(floats)
    tokens = rng.integers(0, jc.vocab, (B, PROMPT)).astype(np.int32)
    return dict(jc=jc, tc=tconfig(jc), qp=qp, tp=convert_tree(_np(qp)),
                tokens=tokens)


@pytest.fixture(scope="module")
def jax_fns(model):
    """JAX's entry points, each jitted once for the module."""
    jc = model["jc"]
    max_len = PROMPT + GEN
    return dict(
        prefill=jax.jit(lambda p, bt: JM.prefill(jc, p, bt,
                                                 max_len=max_len)),
        decode=jax.jit(lambda p, c, t, q: JM.decode_step(jc, p, c, t, q)),
        hidden=jax.jit(lambda p, bt: JM.forward_hidden(jc, p, bt)),
        mtp=jax.jit(lambda p, h, bt: JM.mtp_logits(jc, p, h, bt)),
        serve_prefill=jax.jit(JS.make_serve_prefill(jc, max_len)),
        serve_decode=jax.jit(JS.make_serve_decode(jc)))


def _layer(model, stage):
    """(JAX params, port params) of the one layer of stage ``stage``."""
    jp = jax.tree_util.tree_map(lambda v: v[0],
                                model["qp"]["stages"][stage]["p0"])
    return jp, tql.tree_index(model["tp"]["stages"][stage]["p0"], 0)


# ---------------------------------------------------------------------------
# config, schema, parameter count, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_and_stages_match_jax(smoke):
    jc = jv3.SMOKE if smoke else jv3.CONFIG
    tc = get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)

    def plan(stages):
        return [([dataclasses.asdict(ld) for ld in st.period], st.repeat)
                for st in stages]
    assert plan(build_stages(tc)) == plan(jstages(jc))
    assert [(st.period[0].mixer, st.period[0].ffn, st.repeat)
            for st in build_stages(tc)] == [
        ("mla", "dense", jc.first_dense),
        ("mla", "moe", jc.n_layers - jc.first_dense)]


@pytest.mark.parametrize("smoke", [False, True])
def test_schema_matches_jax(smoke):
    """Every leaf path, shape, init and scale of the port's schema equals
    JAX's: the MLA leaves, the routed and shared experts, the untied head
    and the ``mtp`` subtree (norm_h, norm_e, proj (2d, d), one MLA +
    dense block a depth)."""
    jc = jv3.SMOKE if smoke else jv3.CONFIG
    mine, theirs = {}, {}
    _map_schema(tschema(tconfig(jc)),
                lambda p, s: mine.__setitem__(p, (s.shape, s.init, s.scale)))
    jflat = jax.tree_util.tree_flatten_with_path(
        jschema(jc), is_leaf=lambda x: hasattr(x, "init"))[0]
    for path, s in jflat:
        theirs["/".join(k.key for k in path)] = (tuple(s.shape), s.init,
                                                 s.scale)
    assert mine == theirs
    d = jc.d_model
    assert mine["mtp/proj"][0] == (2 * d, d)
    assert mine["mtp/block/wkv_b"][0] == (
        jc.mtp_depth, jc.kv_lora_rank,
        jc.n_heads * (jc.qk_nope_dim + jc.v_head_dim))
    assert {"lm_head", "mtp/norm_h/gamma", "mtp/norm_e/gamma",
            "stages/s1/p0/moe/w_shared_up", "stages/s0/p0/q_norm",
            "stages/s0/p0/kv_norm"} <= set(mine)


def test_full_config_parameter_count():
    """deepseek-v3-671b's parameter count from the abstract schema (no
    tensor allocated): JAX's count, in (640, 700) B."""
    sizes = []
    _map_schema(tschema(get_config(ARCH)),
                lambda _, s: sizes.append(int(np.prod(s.shape))))
    n = sum(sizes)
    assert n == jparam_count(jschema(jv3.CONFIG))
    assert 640e9 < n < 700e9


def test_init_cache_matches_jax_cache_schema():
    """The port's contiguous caches have the shapes and dtypes of JAX's
    ``cache_schema``: ckv_q (B, Smax, rkv/2) int8, ckv_s (B, Smax) f32,
    kr (B, Smax, dr) in the compute dtype, each layer-stacked."""
    for dtype in ("float32", "bfloat16"):
        jc = jv3.SMOKE.replace(dtype=dtype)
        got = TM.init_cache(tconfig(jc), 3, 10)
        want = jcache_schema(jc, 3, 10)
        for si, st in want["stages"].items():
            for key, spec in st["p0"].items():
                t = got["stages"][si]["p0"][key]
                assert tuple(t.shape) == tuple(spec.shape), key
                assert str(t.dtype).split(".")[-1] == \
                    jnp.dtype(spec.dtype).name, key
                assert not t.any()


def test_contiguous_support_takes_mla():
    """MLA layers serve on the contiguous path: the packed width is the
    compressed KV's (an odd kv_lora_rank is refused), the unread hd is
    not checked; the paged path refuses them, naming the mixer."""
    cfg = get_config(ARCH)
    TM.check_contiguous_support(cfg)
    TM.check_contiguous_support(cfg.replace(head_dim=55))
    with pytest.raises(NotImplementedError, match="kv_lora_rank=511"):
        TM.check_contiguous_support(cfg.replace(kv_lora_rank=511))
    with pytest.raises(NotImplementedError, match="kv_bits=4"):
        TM.check_contiguous_support(cfg.replace(kv_bits=8))
    with pytest.raises(NotImplementedError, match="mixer='mla'"):
        TM.check_paged_support(cfg)


# ---------------------------------------------------------------------------
# SparqleLinear.dequantize and the chunked expert draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["packed", "unpacked", "experts", "layer"])
def test_dequantize_bit_equal_to_jax(case):
    """``SparqleLinear.dequantize`` (f32 ``q * scale + zero``) equals
    JAX's bit for bit: a packed (K, N) projection, an unpacked one, routed
    experts (E, K, N) and one layer of a layer-stacked projection."""
    rng = np.random.default_rng(11)
    shape = {"packed": (64, 48), "unpacked": (64, 48), "experts": (4, 32, 16),
             "layer": (3, 32, 24)}[case]
    leaf = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    if case == "layer":
        jq = jax.jit(lambda a: jquantize({"wq_b": a}, tile_k=16))(leaf)["wq_b"]
        want = [np.asarray(jax.tree_util.tree_map(lambda v: v[i], jq)
                           .dequantize()) for i in range(shape[0])]
        got = [tql.tree_index(convert_tree(_np({"w": jq}))["w"], i)
               .dequantize().numpy() for i in range(shape[0])]
    else:
        jq = jax.jit(lambda a: jquantize_leaf(a, tile_k=16,
                                              pack=case != "unpacked"))(leaf)
        want = [np.asarray(jq.dequantize())]
        got = [convert_tree(_np({"w": jq}))["w"].dequantize().numpy()]
    assert bool(jq.packed) == (case != "unpacked")
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_chunked_expert_quantization_equals_whole():
    """Quantizing a routed-expert leaf a chunk of experts at a time and
    joining the chunks gives the whole leaf's quantization bit for bit:
    packed bytes, scales, zeros and every expert's clip mask."""
    leaf = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (10, 64, 32)).astype(np.float32))
    whole = tql.quantize_leaf(leaf, tile_k=16)
    joined = tql.concat_experts([tql.quantize_leaf(leaf[e:e + 3], tile_k=16)
                                 for e in range(0, 10, 3)])
    for a, b in ((whole.w.q, joined.w.q), (whole.w.scale, joined.w.scale),
                 (whole.w.zero, joined.w.zero),
                 (whole.col_mask, joined.col_mask)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert (joined.l, joined.h, joined.packed) == (whole.l, whole.h, True)
    assert tql.concat_experts([whole]) is whole     # one part: no copy


def test_chunked_expert_draw_equals_whole_draw(monkeypatch):
    """``init_quantized_params`` with the chunk limit cut to 3 experts
    gives the tree of the whole-leaf draw on the CPU (its generator's
    chunks of a draw continue one stream), every leaf bit-equal; and the
    limit leaves deepseek-moe-16b's expert layers whole while it chunks
    deepseek-v3-671b's 15.0 GB ones (counted from the schemas)."""
    limit = tschema_mod.EXPERT_DRAW_BYTES
    for arch, whole in (("deepseek-moe-16b", True), (ARCH, False)):
        c = get_config(arch)
        assert (c.n_experts * c.d_model * c.moe_d_ff * 4 <= limit) == whole
    cfg = get_config(ARCH, smoke=True)
    schema = tschema(cfg)
    want = tschema_mod.init_quantized_params(schema, 0, CPU, tile_k=16)
    monkeypatch.setattr(tschema_mod, "EXPERT_DRAW_BYTES",
                        3 * cfg.d_model * cfg.moe_d_ff * 4)
    got = tschema_mod.init_quantized_params(schema, 0, CPU, tile_k=16)

    def leaves(tree):
        out = []
        for v in tree.values():
            if isinstance(v, dict):
                out += leaves(v)
            elif isinstance(v, tql.SparqleLinear):
                out += [v.w.q, v.w.scale, v.w.zero, v.col_mask]
            else:
                out.append(v)
        return out
    pairs = list(zip(leaves(got), leaves(want)))
    assert len(pairs) == len(leaves(want))
    assert all(torch.equal(a, b) for a, b in pairs)


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------

def test_mla_projections_and_absorbed_weights_match_jax(model):
    """``_mla_q``, ``_mla_ckv`` (prefill and decode shapes) within rtol
    1e-5; the absorbed W_uk/W_uv (the dequantized ``wkv_b``) bit-equal."""
    jc, tc = model["jc"], model["tc"]
    jp, tp = _layer(model, "s1")
    rng = np.random.default_rng(7)
    for shape, pos in (((2, 6, jc.d_model), np.arange(6)),
                       ((2, jc.d_model), np.array([4, 9]))):
        h = rng.standard_normal(shape).astype(np.float32)
        jpos, tpos = jnp.asarray(pos.astype(np.int32)), _t(pos)
        for jfn, tfn in ((JM._mla_q, TM._mla_q), (JM._mla_ckv, TM._mla_ckv)):
            jrun = jax.jit(lambda p, x, q, fn=jfn: fn(jc, p, x, q))
            for w, g in zip(jrun(jp, jnp.asarray(h), jpos),
                            tfn(tc, tp, _t(h), tpos)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=PROJ_RTOL, atol=PROJ_ATOL)
    for w, g in zip(jax.jit(lambda p: JM._mla_absorbed_weights(jc, p))(jp),
                    TM._mla_absorbed_weights(tc, tp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _mla_inputs(seed, b, s, h, dn, dr, dv, rkv):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, dn), (b, s, h, dr), (b, s, rkv), (b, s, dr))
    out = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    out += [(rng.standard_normal((rkv, h, d)) * 0.3).astype(np.float32)
            for d in (dn, dv)]
    return out


@pytest.mark.parametrize("s,bq,bkv", [(16, 8, 16), (13, 8, 8), (24, 16, 8),
                                      (12, 512, 1024)])
def test_mla_flash_matches_jax(s, bq, bkv):
    """The blockwise absorbed attention against JAX's: several q and kv
    blocks, a tail-padded sequence (13 over blocks of 8, 24 over q blocks
    of 16), and blocks cut to the sequence."""
    args = _mla_inputs(s + bq, 2, s, 4, 8, 4, 6, 16)
    want = JM._mla_flash(*map(jnp.asarray, args), causal=True, bq=bq,
                         bkv=bkv)
    got = TM._mla_flash(*map(_t, args), causal=True, bq=bq, bkv=bkv)
    _close(got.numpy(), want, MLA_TOL)


def test_mla_flash_padding_needs_causal():
    args = _mla_inputs(0, 1, 13, 2, 8, 4, 6, 16)
    with pytest.raises(AssertionError, match="non-causal"):
        TM._mla_flash(*map(_t, args), causal=False, bq=8, bkv=8)


def test_mla_absorbed_equals_materialized():
    """The weight-absorbed blockwise MLA equals attention over explicitly
    expanded per-head K = [ckv W_uk; k_rope] and V = ckv W_uv (the
    rewrite's correctness; twin of the JAX package's test)."""
    b, s, H, dn, dr, dv, rkv = 2, 24, 4, 8, 4, 6, 16
    qn, qr, ckv, kr, w_uk, w_uv = map(_t, _mla_inputs(0, b, s, H, dn, dr, dv,
                                                      rkv))
    out = TM._mla_flash(qn, qr, ckv, kr, w_uk, w_uv, causal=True, bq=8,
                        bkv=8)
    k = torch.cat([torch.einsum("bsr,rhd->bshd", ckv, w_uk),
                   kr[:, :, None, :].expand(b, s, H, dr)], -1)
    v = torch.einsum("bsr,rhd->bshd", ckv, w_uv)
    q = torch.cat([qn, qr], -1)
    sc = torch.einsum("bihd,bjhd->bhij", q, k) * (dn + dr) ** -0.5
    i = torch.arange(s)
    sc = torch.where(i[None, :] <= i[:, None], sc, TM.NEG_INF)
    ref = torch.einsum("bhij,bjhd->bihd", torch.softmax(sc, -1), v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mla_flash_pad_invariance():
    """A length the blocks do not divide (MTP's S - 1) is tail-padded:
    blocks of 8 over 13 positions equal one block of 13."""
    args = list(map(_t, _mla_inputs(7, 1, 13, 2, 8, 4, 6, 16)))
    a = TM._mla_flash(*args, causal=True, bq=8, bkv=8)
    full = TM._mla_flash(*args, causal=True, bq=13, bkv=13)
    np.testing.assert_allclose(a.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def _layer_cache(tc, b, smax):
    """A zeroed contiguous cache of one MLA layer (no layer axis)."""
    return {k: v[0] for k, v in
            TM.init_cache(tc, b, smax)["stages"]["s0"]["p0"].items()}


def _same_cache(mine, theirs):
    """The packed nibbles bit-equal; the scales within rtol 1e-6 (the
    compressed KV they scale comes out of an f32 RMSNorm, whose row sum
    XLA orders otherwise: a few ulps) and the rope keys within 1e-6."""
    np.testing.assert_array_equal(mine["ckv_q"].numpy(), theirs["ckv_q"])
    np.testing.assert_allclose(mine["ckv_s"].numpy(), theirs["ckv_s"],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(mine["kr"].numpy(), theirs["kr"], atol=1e-6)


def test_kv_quant_of_compressed_kv_bit_equal_to_jax(model):
    """``_kv_quant`` of the same compressed KV (B, S, rkv) and (B, rkv):
    packed nibbles and scales bit-equal, and ``_kv_dequant`` of them."""
    jc, tc = model["jc"], model["tc"]
    rng = np.random.default_rng(12)
    for shape in ((2, 7, jc.kv_lora_rank), (3, jc.kv_lora_rank)):
        ckv = rng.standard_normal(shape).astype(np.float32) * 3
        jq, js = JM._kv_quant(jc, jnp.asarray(ckv))
        tq, ts = TM._kv_quant(tc, _t(ckv))
        assert tq.shape == shape[:-1] + (shape[-1] // 2,)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            TM._kv_dequant(tc, tq, ts, torch.float32).numpy(),
            np.asarray(JM._kv_dequant(jc, jq, js, jnp.float32)))


def test_mla_full_and_decode_match_jax(model):
    """``mla_full`` (output within 1e-4 of max |out|, the cache it writes
    against the cache JAX's builds) and ``mla_decode`` from JAX's cache
    at two positions: output within 1e-4 of max |out|, the cache after
    the write as JAX's (``_same_cache``)."""
    jc, tc = model["jc"], model["tc"]
    jp, tp = _layer(model, "s1")
    ld, jld = LayerDef("mla", "moe"), JLayerDef("mla", "moe")
    s, smax = 12, 16
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    jout, jcache = jax.jit(lambda p, a: JM.mla_full(
        jc, jld, p, a, jnp.arange(s), 0, smax))(jp, jnp.asarray(x))
    cache = _layer_cache(tc, 2, smax)
    tout, _ = TM.mla_full(tc, ld, tp, _t(x), torch.arange(s), 0, cache)
    _close(tout.numpy(), jout, MLA_TOL)
    jcache = _np(jcache)
    _same_cache(cache, jcache)

    x1 = rng.standard_normal((2, jc.d_model)).astype(np.float32)
    pos = np.array([s, s + 2], np.int32)
    jout, jnew = jax.jit(lambda p, a, c, q: JM.mla_decode(
        jc, jld, p, a, c, q))(jp, jnp.asarray(x1), jcache, jnp.asarray(pos))
    mine = {k: _t(v) for k, v in jcache.items()}
    tout, _ = TM.mla_decode(tc, ld, tp, _t(x1), mine, _t(pos))
    _close(tout.numpy(), jout, MLA_TOL)
    _same_cache(mine, _np(jnew))


# ---------------------------------------------------------------------------
# routing at E = 256
# ---------------------------------------------------------------------------

def test_sigmoid_router_e256_top8_matches_jax():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((24, 64)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((64, 256)) / 8, jnp.float32)
    jv, ji = jmoe.router(x, w, "sigmoid", 8)
    tv, ti = tmoe.router(to_tensor(x), to_tensor(w), "sigmoid", 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("tokens", [8, 64], ids=["decode", "prefill"])
def test_routed_experts_e256_top8_match_jax(tokens):
    """The routed experts at deepseek-v3's routing (256 experts, top-8
    sigmoid) on narrow experts and the same flat tokens: at decode 8
    tokens' 64 assignments give capacity 1 and colliding assignments
    drop exactly as JAX drops them (asserted to happen); 64 tokens give
    capacity 2."""
    rng = np.random.default_rng(1)
    d, f, e = 32, 16, 256

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape) / np.sqrt(shape[-2]),
                           jnp.float32)
    ws = {"w_router": w(d, e)}
    quant = jax.jit(lambda a: jquantize_leaf(a, enable_clipping=False))
    ws.update({k: quant(w(*sh)) for k, sh in
               (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                ("w_down", (e, f, d)))})
    tw = convert_tree(_np(ws))
    x = rng.standard_normal((tokens, d)).astype(np.float32)
    cap = tmoe.capacity(tokens, 8, e)
    assert cap == max(1, tokens * 8 // e)
    _, ids = tmoe.router(_t(x), tw["w_router"], "sigmoid", 8)
    assert (torch.bincount(ids.reshape(-1), minlength=e) > cap).any()
    kw = dict(top_k=8, capacity_factor=1.0, router_type="sigmoid")
    want = jax.jit(lambda a, p: jmoe.moe_ffn_dist(
        a, p["w_router"], p["w_gate"], p["w_up"], p["w_down"], **kw))(
        jnp.asarray(x), ws)
    got = tmoe.moe_ffn(_t(x), tw["w_router"], tw["w_gate"], tw["w_up"],
                       tw["w_down"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the model: prefill, decode_step, forward_hidden, mtp_logits, the serve
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_jax(model, jax_fns):
    """Prefill and GEN - 1 decode steps fed JAX's tokens: logits within
    1e-4 of max |logit| at every step, every layer's cache as JAX's
    (``_same_cache``) after the prefill and after the last step."""
    tc, tokens = model["tc"], model["tokens"]
    jlog, jcache = jax_fns["prefill"](model["qp"], {"tokens": jnp.asarray(
        tokens)})
    tlog, tcache = TM.prefill(tc, model["tp"], {"tokens": _t(tokens)},
                              max_len=PROMPT + GEN)
    _close(tlog.numpy(), jlog, LOGIT_TOL)

    def same_bytes():
        for si, layer in _np(jcache)["stages"].items():
            _same_cache(tcache["stages"][si]["p0"], layer["p0"])
    same_bytes()
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for i in range(GEN - 1):
        pos = np.full((B,), PROMPT + i, np.int32)
        jlog, jcache = jax_fns["decode"](model["qp"], jcache,
                                         jnp.asarray(tok), jnp.asarray(pos))
        tlog, tcache = TM.decode_step(tc, model["tp"], tcache, _t(tok),
                                      _t(pos))
        _close(tlog.numpy(), jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    same_bytes()


def test_legacy_greedy_streams_match_jax(model, jax_fns):
    """``serve.legacy_serve`` and the port's ``make_serve_prefill``/
    ``make_serve_decode`` loop against JAX's jitted serve steps (its
    ``_legacy_serve`` loop): identical greedy streams."""
    tc, tokens = model["tc"], model["tokens"]
    tok, cache = jax_fns["serve_prefill"](model["qp"],
                                          {"tokens": jnp.asarray(tokens)})
    want = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, cache = jax_fns["serve_decode"](
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


def test_forward_hidden_and_mtp_logits_match_jax(model, jax_fns):
    """``forward_hidden`` within 1e-4 of max |h|; ``mtp_logits`` on JAX's
    hidden states within 1e-4 of max |logit| ((B, S - 1, V): the MTP
    block's MLA runs on S - 1 = 19 positions)."""
    jb = {"tokens": jnp.asarray(model["tokens"])}
    tb = {"tokens": _t(model["tokens"])}
    jh = jax_fns["hidden"](model["qp"], jb)
    th = TM.forward_hidden(model["tc"], model["tp"], tb)
    _close(th.numpy(), jh, LOGIT_TOL)
    want = jax_fns["mtp"](model["qp"], jh, jb)
    got = TM.mtp_logits(model["tc"], model["tp"], _t(np.asarray(jh)), tb)
    assert got.shape == (B, PROMPT - 1, model["jc"].vocab)
    _close(got.numpy(), want, LOGIT_TOL)


def test_mla_decode_through_traced_runner(model):
    """The fixed-batch decode step on MLA caches through ``CompiledStep``
    with the trace stand-in of a CUDA-graph capture (``FxGraph``: the
    capture's constraints, no host read): traced once, run at later
    inputs, outputs and every cache byte equal the eager step's."""
    tc, tp = model["tc"], model["tp"]
    g = torch.Generator().manual_seed(4)
    cache = fill_random(TM.init_cache(tc, 3, 16), g)
    calls = [(torch.randint(0, tc.vocab, (3,), generator=g,
                            dtype=torch.int32),
              torch.randint(0, 16, (3,), generator=g, dtype=torch.int32))
             for _ in range(4)]
    case = ("legacy_decode", TS.make_serve_decode(tc), (tp, cache), calls)
    assert replay_vs_eager(CPU, case, graph_type=FxGraph)


def test_serve_cli_legacy_and_refusal(capsys):
    """``serve --arch deepseek-v3-671b --smoke --legacy`` on the CPU
    prints its streams and the closing report; without ``--legacy`` it
    exits as the JAX serve does, naming the mla mixer."""
    r = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--legacy", "--batch", "2", "--prompt-len", "12",
                    "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated 2 x 3 tokens" in out
    assert "MSB4 sub-precision sparsity of hidden activations" in out
    assert [len(s) for s in r["streams"]] == [3, 3]
    assert 0 < r["hidden_sparsity"] < 1
    with pytest.raises(SystemExit, match=r"mixer='mla'.*\n\(this arch "
                                         r"serves via --legacy only\)"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])

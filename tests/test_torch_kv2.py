"""Port parity, KV2 precision ladder: the width-k plane codec, the tier
re-codecs, the pool's ladder bookkeeping, the mixed-tier attention's
plain version, the tiered decode step and the ``Engine`` with
``PoolConfig(kv2_pages > 0)`` against the JAX package on the same numpy
inputs (CPU, plain versions; the Pallas kernels in interpret mode), and
the bench's KV2 section against its recorded counters
(``benchmarks/baselines/serving.json``, ``serving_kv2/*``).

Tolerances: integers exact (fields, nibbles, page ids, tiers, free
lists, counters, bytes, token streams), as are the pool's page
sparsities (integer counts over one f32 division) and byte-equal pool
states; tiered attention within 1e-5 of the Pallas kernel in f32 (the
plain softmax sums in another order), and bit-exact with the port's own
KV4 plain version on tier-0 and on clamped pages; logits within 1e-4
(as in ``test_torch_model.py``)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.packing import pack_plane as jpack_plane
from repro.core.packing import unpack_plane as junpack_plane
from repro.core.qlinear import quantize_model_params as jquantize
from repro.kernels.kv_attention import \
    kv_tiered_paged_decode_attention as jtiered_attn
from repro.launch import steps as JS
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PagedKVPool as JPagedKVPool
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro.serving import tiering as jtiering
from repro.serving.kv_pool import init_pool_state as jinit_pool
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_numpy_tree
from repro_torch.core.packing import pack_plane, unpack_plane
from repro_torch.kernels import ref
from repro_torch.kernels.kv_attention import kv_tiered_paged_decode_attention
from repro_torch.launch import steps as TS
from repro_torch.serving import (Engine, PagedKVPool, PoolConfig,
                                 SamplingParams, SchedulerConfig, SpecConfig,
                                 SpeculativeEngine, tiering)
from repro_torch.serving.kv_pool import init_pool_state

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import bench_serving as B  # noqa: E402

CFG = JConfig(name="tiny-kv2", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
PS = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_trees_equal(t_tree, j_tree):
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           to_numpy_tree(t_tree), _np(j_tree))


@pytest.fixture(scope="module")
def qparams():
    fp = jinit(jschema(CFG), jax.random.PRNGKey(0))
    return jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     mode="sparqle", enable_clipping=True, tile_k=16)


@pytest.fixture(scope="module")
def tparams(qparams):
    return convert_tree(_np(qparams))


# ---------------------------------------------------------------------------
# plane codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_pack_unpack_plane_match_jax_exhaustive(width):
    """Every int8 value packs as JAX packs it, and every byte unpacks
    (signed and unsigned) to JAX's fields; pack inverts unpack."""
    per = 8 // width
    vals = np.tile(np.arange(-128, 128, dtype=np.int8), per).reshape(-1, 32)
    got = pack_plane(_t(vals), width=width)
    want = np.asarray(jpack_plane(jnp.asarray(vals), width=width))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    for signed in (True, False):
        fields = unpack_plane(_t(every_byte), width=width, signed=signed)
        np.testing.assert_array_equal(
            fields.numpy(),
            np.asarray(junpack_plane(jnp.asarray(every_byte), width=width,
                                     signed=signed)))
        np.testing.assert_array_equal(
            pack_plane(fields, width=width).numpy(), every_byte)
    with pytest.raises(ValueError):
        pack_plane(_t(vals), width=3)


# ---------------------------------------------------------------------------
# tier re-codecs
# ---------------------------------------------------------------------------

def _random_pool(rng, n_pages=8, kv2_pages=5, in_band=False):
    """A JAX pool state (numpy) with random K/V bytes and scales; with
    ``in_band`` every KV4 nibble lies in the int2 band [-2, 1]."""
    state = _np(jinit_pool(CFG, JPool(n_pages=n_pages, page_size=PS,
                                      kv2_pages=kv2_pages)))

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif v.dtype == np.int8 and k in ("k_q", "v_q") and in_band:
                nib = rng.integers(-2, 2, v.shape[:-1] + (v.shape[-1] * 2,))
                out[k] = np.asarray(jpack_plane(jnp.asarray(nib, jnp.int8),
                                                width=4))
            elif v.dtype == np.int8:
                out[k] = rng.integers(-128, 128, v.shape).astype(np.int8)
            else:
                out[k] = rng.uniform(0.01, 0.3, v.shape).astype(np.float32)
        return out
    return fill(state)


@pytest.mark.parametrize("in_band", [True, False])
def test_demote_promote_match_jax(in_band):
    """demote/promote re-encode every layer's page as JAX's jitted ops do
    (every leaf byte-equal); demote -> promote is the identity on an
    in-band page and the clamp image elsewhere."""
    state = _random_pool(np.random.default_rng(int(in_band)),
                         in_band=in_band)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = convert_tree(state)
    jstate = jtiering.demote_page(jstate, jnp.int32(2), jnp.int32(3))
    assert tiering.demote_page(tstate, 2, 3) is tstate
    _assert_trees_equal(tstate, jstate)
    jstate = jtiering.promote_page(jstate, jnp.int32(3), jnp.int32(5))
    tiering.promote_page(tstate, 3, 5)
    _assert_trees_equal(tstate, jstate)
    lp = to_numpy_tree(tstate)["stages"]["s0"]["p0"]
    for q, s in (("k_q", "k_s"), ("v_q", "v_s")):
        np.testing.assert_array_equal(lp[s][:, 5], lp[s][:, 2])
        nib = unpack_plane(_t(lp[q][:, 2]), width=4, signed=True).numpy()
        back = unpack_plane(_t(lp[q][:, 5]), width=4, signed=True).numpy()
        np.testing.assert_array_equal(back, np.clip(nib, -2, 1))
        assert (back == nib).all() == in_band


@pytest.mark.parametrize("in_band", [True, False])
def test_device_page_ids_match_host_ints_and_jax(in_band):
    """The re-codecs at page ids given as 0-d int32 tensors (what their
    compiled steps take), at host ints, and JAX's jitted ones at traced
    int32 scalars, on the same pool bytes: every leaf byte-equal after
    each of a demotion, a promotion and a second demotion; the pool's
    ``PageRecodecs`` (ids through its id buffer) give the same bytes."""
    state = _random_pool(np.random.default_rng(10 + in_band),
                         in_band=in_band)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    ints, ids, codecs = (convert_tree(state) for _ in range(3))
    recodecs = tiering.PageRecodecs("cpu")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for op, src, dst in (("demote", 6, 2), ("promote", 2, 1),
                         ("demote", 1, 4)):
        jstate = getattr(jtiering, f"{op}_page")(jstate, jnp.int32(src),
                                                 jnp.int32(dst))
        fn = getattr(tiering, f"{op}_page")
        assert fn(ints, src, dst) is ints
        assert fn(ids, i32(src), i32(dst)) is ids
        assert getattr(recodecs, op)(codecs, src, dst) is codecs
        for tree in (ints, ids, codecs):
            _assert_trees_equal(tree, jstate)


# ---------------------------------------------------------------------------
# pool ladder bookkeeping
# ---------------------------------------------------------------------------

def _assert_pools_agree(tp, jp):
    owners = sorted(jp._owned)
    assert sorted(tp._owned) == owners
    for o in owners:
        assert tp.pages_of(o) == jp.pages_of(o), o
        assert tp.tiers_of(o) == jp.tiers_of(o), o
        assert tp.tier_stats_of(o) == jp.tier_stats_of(o), o
    assert list(tp._free) == list(jp._free[0])
    assert list(tp._free_kv2) == list(jp._free_kv2)
    for attr in ("demotions", "promotions", "kv_bytes_reclaimed", "clock",
                 "kv2_used", "kv2_free", "evictions"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.kv_bytes_saved() == jp.kv_bytes_saved()
    assert tp.kv_bytes_held() == jp.kv_bytes_held()
    assert tp._page_bytes == jp._page_bytes
    _assert_trees_equal(tp.state, jp.state)


def test_pool_ladder_matches_jax():
    """The same allocate / tick / demote_cold / touch / pressure /
    truncate / release sequence on both pools: equal pages, tiers, free
    lists, counters, page sparsities and byte-equal device state. Pages
    1-4 hold in-band nibbles (sparsity 1), the rest random (about 1/4),
    so the 0.5 floor demotes some candidates and skips others."""
    rng = np.random.default_rng(3)
    cfg = dict(n_pages=12, page_size=PS, kv2_pages=6,
               demote_min_sparsity=0.5, demote_after_steps=2)
    jp = JPagedKVPool(CFG, JPool(**cfg))
    tp = PagedKVPool(TCFG, PoolConfig(**cfg))
    state = _random_pool(rng, n_pages=12, kv2_pages=6)
    band = _random_pool(rng, n_pages=12, kv2_pages=6, in_band=True)
    for key in ("k_q", "v_q"):
        state["stages"]["s0"]["p0"][key][:, 1:5] = \
            band["stages"]["s0"]["p0"][key][:, 1:5]
    jp.state = jax.tree_util.tree_map(jnp.asarray, state)
    tp.state = convert_tree(state)
    pages = list(range(12))
    np.testing.assert_array_equal(tp.page_msb_sparsity(pages),
                                  jp.page_msb_sparsity(pages))
    sp = tp.page_msb_sparsity(pages)
    assert (sp[1:5] == 1.0).all() and (sp[5:] < 0.5).all()

    def both(fn):
        a, b = fn(tp, True), fn(jp, False)
        assert a == b
        return a

    both(lambda p, _: p.allocate(3, owner="a"))          # pages 1, 2, 3
    both(lambda p, _: p.allocate(3, owner="b"))          # 4, 5, 6
    both(lambda p, _: p.allocate(2, owner="c"))          # 7, 8
    both(lambda p, _: p.set_demotable(["a", "b", "c"]))
    for _ in range(2):
        both(lambda p, _: p.tick())
    assert both(lambda p, _: p.demote_cold()) == 3       # 1, 2, 4
    _assert_pools_agree(tp, jp)
    both(lambda p, _: p.touch("a", 0, 0))                # promote a[0]
    both(lambda p, _: p.tick())
    assert both(lambda p, t: p.demote_for_pressure(n=2) if t
                else p.demote_for_pressure(0, n=2)) == 2
    _assert_pools_agree(tp, jp)
    both(lambda p, _: p.truncate("b", PS))               # keeps b[0]
    both(lambda p, _: p.release("c"))
    both(lambda p, _: p.allocate(2, owner="d"))
    _assert_pools_agree(tp, jp)
    assert tp.promotions == 1 and tp.demotions == 5


def _pool(**kw):
    cfg = dict(n_pages=8, page_size=PS, kv2_pages=4,
               demote_min_sparsity=0.0, demote_after_steps=1)
    cfg.update(kw)
    return PagedKVPool(TCFG, PoolConfig(**cfg))


def test_pool_demote_promote_bookkeeping():
    pool = _pool()
    pool.allocate(3, owner="a")
    pool.set_demotable(["a"])
    pool.tick()
    pool.tick()
    assert pool.demote_cold() == 2          # frontier page protected
    assert pool.tiers_of("a") == [1, 1, 0]
    assert pool.demotions == 2 and pool.kv2_used == 2
    assert pool.kv_bytes_reclaimed == pool.kv_bytes_saved() > 0
    pool.touch("a", 0, 1)                   # promote back (exact)
    assert pool.tiers_of("a") == [0, 0, 0]
    assert pool.promotions == 2 and pool.kv2_used == 0
    assert pool.kv_bytes_saved() == 0
    assert pool.tier_stats_of("a") == {"demotions": 2, "promotions": 2}


def test_pool_demote_requires_demotable_owner():
    pool = _pool()
    pool.allocate(3, owner="a")
    pool.tick()
    pool.tick()
    assert pool.demote_cold() == 0          # not in the demotable set
    pool.set_demotable(["a"])
    assert pool.demote_cold() == 2
    pool.release("a")                       # release purges the set too
    pool.allocate(3, owner="a")
    pool.tick()
    pool.tick()
    assert pool.demote_cold() == 0


def test_pool_release_routes_pages_to_their_tiers():
    pool = _pool()
    pool.allocate(3, owner="a")
    pool.set_demotable(["a"])
    pool.tick()
    pool.demote_cold()
    free4, free2 = pool.num_free, pool.kv2_free
    pool.release("a")
    assert pool.num_free == free4 + 1       # one KV4 page was still held
    assert pool.kv2_free == free2 + 2       # two KV2 pages returned
    assert pool.kv2_used == 0


def test_pool_demote_for_pressure_ignores_sparsity():
    pool = _pool(demote_min_sparsity=1.1)   # the cold sweep never fires
    pool.allocate(3, owner="a")
    pool.set_demotable(["a"])
    pool.tick()
    assert pool.demote_cold() == 0
    assert pool.demote_for_pressure(n=2) == 2
    assert pool.tiers_of("a") == [1, 1, 0]


def test_pool_disarmed_ladder_is_inert():
    pool = _pool(kv2_pages=0)
    pool.allocate(2, owner="a")
    pool.set_demotable(["a"])
    pool.tick()
    pool.tick()
    assert not pool.kv2_armed
    assert pool.demote_cold() == 0 and pool.demote_for_pressure() == 0
    assert pool.kv_bytes_saved() == 0 and pool.kv2_used == 0
    assert "k2_q" not in pool.state["stages"]["s0"]["p0"]


@pytest.mark.parametrize("kv2_pages,head_dim", [(1, 8), (4, 6)])
def test_pool_rejects_tiny_slab_and_unpackable_head(kv2_pages, head_dim):
    cfg = dataclasses.replace(TCFG, head_dim=head_dim)
    with pytest.raises(ValueError):
        PagedKVPool(cfg, PoolConfig(n_pages=8, page_size=PS,
                                    kv2_pages=kv2_pages))


def test_pool_state_with_kv2_slab_converts():
    """``convert_tree`` carries a JAX pool state's k2_*/v2_* leaves
    unchanged (its walk is generic)."""
    pc = dict(n_pages=6, page_size=PS, kv2_pages=3)
    got = convert_tree(_np(jinit_pool(CFG, JPool(**pc))))
    want = init_pool_state(TCFG, PoolConfig(**pc))
    assert set(got["stages"]["s0"]["p0"]) == {
        "k_q", "k_s", "v_q", "v_s", "k2_q", "k2_s", "v2_q", "v2_s"}
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           to_numpy_tree(got), to_numpy_tree(want))


# ---------------------------------------------------------------------------
# mixed-tier attention, plain version
# ---------------------------------------------------------------------------

def _tiered_inputs(seed=5, b=4, kvh=2, g=2, hd=16, ps=4, n_pages=20,
                   n2=9, n_s=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    kp, vp = (rng.integers(-128, 128, (n_pages, ps, kvh, hd // 2))
              .astype(np.int8) for _ in range(2))
    k2, v2 = (rng.integers(-128, 128, (n2, ps, kvh, hd // 4))
              .astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.3, (n_pages, ps, kvh)).astype(np.float32)
              for _ in range(2))
    k2s, v2s = (rng.uniform(0.01, 0.3, (n2, ps, kvh)).astype(np.float32)
                for _ in range(2))
    tiers = (rng.random((b, n_s)) < 0.5).astype(np.int32)
    tables = np.where(tiers == 1, rng.integers(1, n2, (b, n_s)),
                      (rng.permutation(n_pages - 1)[:b * n_s] + 1)
                      .reshape(b, n_s)).astype(np.int32)
    tables[-1], tiers[-1] = 0, 0                     # inactive slot
    pos = np.array([ps - 1, ps, n_s * ps - 1, 0][:b], np.int32)
    return q, kp, ks, vp, vs, k2, k2s, v2, v2s, tables, tiers, pos


def test_tiered_attention_plain_matches_pallas():
    args = _tiered_inputs()
    assert args[-2].any() and not args[-2].all()     # mixed tiers
    got = kv_tiered_paged_decode_attention(*map(_t, args)).numpy()
    want = np.asarray(jtiered_attn(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()


def test_tiered_attention_plain_equals_kv4_on_tier0_and_clamped_pages():
    """All tier 0: the KV4 plain version's bits. Demoted pages: the bits
    of the KV4 plain version over the pages clamped to [-2, 1]."""
    q, kp, ks, vp, vs, k2, k2s, v2, v2s, _, tiers, pos = map(
        _t, _tiered_inputs(seed=6))
    # distinct KV4 pages per slot, so clamping slot 0's touches no other
    tables = _t((np.random.default_rng(6).permutation(19)[:16] + 1)
                .reshape(4, 4).astype(np.int32))
    tables[-1] = 0
    zeros = torch.zeros_like(tiers)
    kv4 = ref.kv4_paged_decode_attention_ref(q, kp, ks, vp, vs, tables, pos)
    got = ref.kv_tiered_paged_decode_attention_ref(
        q, kp, ks, vp, vs, k2, k2s, v2, v2s, tables, zeros, pos)
    assert torch.equal(got, kv4)
    # demote every page of slot 0 into fresh KV2 pages 1..4
    tier = zeros.clone()
    tier[0] = 1
    tables2 = tables.clone()
    tables2[0] = torch.arange(1, 5)
    k2c, v2c, k2sc, v2sc = k2.clone(), v2.clone(), k2s.clone(), v2s.clone()
    kpc, vpc = kp.clone(), vp.clone()
    for i, page in enumerate(tables[0].tolist()):
        for src, dst, src_s, dst_s, clamped in ((kp, k2c, ks, k2sc, kpc),
                                                (vp, v2c, vs, v2sc, vpc)):
            nib = torch.clamp(unpack_plane(src[page], width=4, signed=True),
                              -2, 1)
            dst[i + 1] = pack_plane(nib, width=2)
            dst_s[i + 1] = src_s[page]
            clamped[page] = pack_plane(nib, width=4)
    got = ref.kv_tiered_paged_decode_attention_ref(
        q, kp, ks, vp, vs, k2c, k2sc, v2c, v2sc, tables2, tier, pos)
    want = ref.kv4_paged_decode_attention_ref(q, kpc, ks, vpc, vs, tables,
                                              pos)
    assert torch.equal(got, want)
    assert not torch.equal(got[0], kv4[0])


# ---------------------------------------------------------------------------
# the tiered decode step
# ---------------------------------------------------------------------------

def test_tiered_decode_step_matches_jax(qparams, tparams):
    """decode_step_paged with tier tables against JAX's on one random
    pool with demoted pages: logits, telemetry and the pool after the
    step. Slot 1's frontier page is tier 1, so its write is masked to
    the KV4 null page in both."""
    state = _random_pool(np.random.default_rng(9), n_pages=12, kv2_pages=6)
    jpool = jax.tree_util.tree_map(jnp.asarray, state)
    tpool = convert_tree(state)
    tables = np.array([[3, 2, 7, 0], [1, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    tiers = np.array([[0, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    token = np.array([5, 9, 0], np.int32)
    pos = np.array([9, 6, 0], np.int32)
    jl, jpool, jt = jax.jit(JS.make_engine_decode(CFG, kv2=True))(
        qparams, jpool, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(tiers))
    tl, _, tt = TS.make_engine_decode(TCFG, kv2=True)(
        tparams, tpool, _t(token), _t(pos), _t(tables), _t(tiers))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("layer_wire_bytes", "layer_dense_bytes", "sparsity",
                "layer_sparsity"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))
    lp_j = _np(jpool)["stages"]["s0"]["p0"]
    lp_t = to_numpy_tree(tpool)["stages"]["s0"]["p0"]
    for key in ("k_q", "v_q", "k2_q", "k2_s", "v2_q", "v2_s"):
        np.testing.assert_array_equal(lp_t[key][:, 1:], lp_j[key][:, 1:])
    for key in ("k_s", "v_s"):
        np.testing.assert_allclose(lp_t[key][:, 1:], lp_j[key][:, 1:],
                                   rtol=1e-6)
    # slot 1 wrote nowhere but the null page: the KV4 pages no slot
    # writes are unchanged, and slot 0 wrote into its page 7
    before = state["stages"]["s0"]["p0"]["k_q"]
    np.testing.assert_array_equal(lp_t["k_q"][:, 1:7], before[:, 1:7])
    assert (lp_t["k_q"][:, 7] != before[:, 7]).any()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _drive_kv2(eng, trace, sampling_cls):
    """``bench_serving._drive_kv2``: the step-indexed trace, tracking the
    peak share of held KV bytes that demotion reclaims."""
    handles, i, step, peak = [], 0, 0, 0.0
    while i < len(trace) or eng.sched.has_work():
        while i < len(trace) and trace[i][0] <= step:
            _, prompt, gen = trace[i]
            handles.append(eng.submit(prompt,
                                      sampling_cls(max_new_tokens=gen)))
            i += 1
        if eng.sched.has_work():
            eng.step()
            saved = eng.pool.kv_bytes_saved()
            if saved:
                peak = max(peak, saved / (saved + eng.pool.kv_bytes_held()))
        step += 1
    return handles, peak


def _kv2_trace(seed=0):
    """``bench_serving._run_kv2_ladder``'s trace."""
    rng = np.random.default_rng(seed + 1)
    t, trace = 0.0, []
    for _ in range(3):
        t += rng.exponential(1.0)
        plen = int(rng.integers(48, 64))
        gen = int(rng.integers(24, 32))
        trace.append((int(np.ceil(t / B.STEP_DT)),
                      rng.integers(0, B.KV2_CFG.vocab, plen).tolist(), gen))
    return trace


def test_bench_kv2_counters_match_baseline_and_jax():
    """The bench's KV2 section through the port's Engine — disarmed,
    armed but idle, and the aggressive cold sweep — gives serving.json's
    serving_kv2/* counters, and the aggressive run's streams, counters
    and per-request ladder stats equal the JAX engine's."""
    qp = jquantize(B.draft_friendly_params(B.KV2_CFG, seed=0), w_bits=4,
                   k_percent=50.0, clip_l=-8.0, clip_h=23.0, mode="sparqle",
                   enable_clipping=True, tile_k=16)
    params = convert_tree(_np(qp))
    cfg = ModelConfig(**dataclasses.asdict(B.KV2_CFG))
    trace = _kv2_trace()
    sched = dict(max_decode_batch=4, token_budget=96, prefill_chunk=32,
                 max_pages_per_seq=12)

    def make(kv2_pages, **kw):
        return Engine(cfg, params, device="cpu",
                      pool_config=PoolConfig(n_pages=24, page_size=16,
                                             kv2_pages=kv2_pages, **kw),
                      sched_config=SchedulerConfig(**sched))

    base = make(0)
    base_h, _ = _drive_kv2(base, trace, SamplingParams)
    idle = make(24, demote_after_steps=10**9)
    idle_h, _ = _drive_kv2(idle, trace, SamplingParams)
    assert idle.pool.demotions == 0
    assert [h.out_tokens for h in idle_h] == [h.out_tokens for h in base_h]

    eng = make(24, demote_after_steps=1, demote_min_sparsity=0.0)
    hs, peak = _drive_kv2(eng, trace, SamplingParams)
    agg = eng.aggregate_stats()
    assert agg["pool_demotions"] == 14
    assert agg["pool_promotions"] == 0
    assert agg["kv_bytes_reclaimed"] == 14336
    assert round(peak * 100.0, 2) == 33.33
    assert eng.steps == 64
    assert sum(h.n_generated for h in hs) == 87
    assert agg["pool_evictions"] == 0
    assert sum(h.stats()["kv_demotions"] for h in hs) == 14
    snap = eng.metrics_snapshot()
    assert "serving_pool_kv2_pages_used" in snap
    assert eng._m_step_lat.count(phase="demote") == 64

    jeng = JEngine(B.KV2_CFG, qp,
                   pool_config=JPool(n_pages=24, page_size=16, kv2_pages=24,
                                     demote_after_steps=1,
                                     demote_min_sparsity=0.0),
                   sched_config=JSched(**sched))
    jh, jpeak = _drive_kv2(jeng, trace, JSampling)
    assert [h.out_tokens for h in hs] == [h.out_tokens for h in jh]
    assert peak == jpeak
    ja = jeng.aggregate_stats()
    for key in ("pool_demotions", "pool_promotions", "kv_bytes_reclaimed",
                "kv2_pages_used", "kv_bytes_saved", "steps",
                "pool_pages_free"):
        assert agg[key] == ja[key], key
    for a, b in zip(hs, jh):
        for key in ("kv_demotions", "kv_promotions", "n_generated"):
            assert a.stats()[key] == b.stats()[key], key


def _run_engine(params, pool_cfg, gen=24):
    eng = Engine(TCFG, params, pool_config=pool_cfg, device="cpu",
                 sched_config=SchedulerConfig(
                     max_decode_batch=2, token_budget=32, prefill_chunk=8,
                     max_pages_per_seq=16))
    hs = [eng.submit(p, SamplingParams(max_new_tokens=gen))
          for p in ([1, 2, 3, 4, 5], [7, 8, 9])]
    eng.run()
    return eng, [h.out_tokens for h in hs]


def test_engine_pressure_rung_prevents_eviction(tparams):
    """Under page pressure the ladder demotes before anyone is preempted:
    the pool that makes the disarmed engine evict drains without an
    eviction when KV2 pages absorb the pressure."""
    base, _ = _run_engine(tparams, PoolConfig(n_pages=12, page_size=PS))
    eng, toks = _run_engine(tparams, PoolConfig(
        n_pages=12, page_size=PS, kv2_pages=12,
        demote_after_steps=10**9))           # the pressure rung only
    assert base.pool.evictions > 0
    assert eng.pool.evictions == 0
    assert eng.pool.demotions > 0
    assert all(len(t) == 24 for t in toks)


def test_spec_engine_rejects_kv2(tparams):
    with pytest.raises(NotImplementedError):
        SpeculativeEngine(TCFG, tparams, spec=SpecConfig(gamma=2),
                          device="cpu",
                          pool_config=PoolConfig(n_pages=32, page_size=PS,
                                                 kv2_pages=8))

"""Port parity, self-speculative decoding: the LSB4-only draft matmul, the
multi-token verify attention, the draft step, the verify window, pool
truncation, the scheduler's draft accounting and the ``SpeculativeEngine``
of the port against the JAX package on the same numpy inputs (CPU, plain
versions; the Pallas kernels in interpret mode), and the bench trace's
recorded counters (``benchmarks/baselines/serving.json``).

Tolerances: integers exact (matmul accumulators, pool nibbles, page and
scheduler bookkeeping, token streams, step and ``spec_*`` counters,
wire bytes); logits within 1e-4 and attention within 1e-5 in f32 (sums
in other orders than XLA's); pool scales within 1e-6 relative (an ulp of
RoPE can move a K/V row's absmax); the port's verify window against its
own decode steps exact."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.kernels.kv_attention import \
    kv4_paged_verify_attention as jverify_attn
from repro.kernels.sparqle_matmul import sparqle_matmul as jsparqle_matmul
from repro.launch import steps as JS
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import PagedKVPool as JPagedKVPool
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import Scheduler as JScheduler
from repro.serving import SchedulerConfig as JSched
from repro.serving import SpecConfig as JSpecConfig
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_numpy_tree
from repro_torch.core import qlinear as tql
from repro_torch.kernels import ref
from repro_torch.kernels.ref import TILE_K, TILE_M
from repro_torch.kernels.sparqle_matmul import sparqle_matmul
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.serving import (Engine, PagedKVPool, PoolConfig,
                                 SamplingParams, Scheduler, SchedulerConfig,
                                 SpecConfig, SpeculativeEngine)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import bench_serving as B  # noqa: E402

CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
PS, NPAGES, PMAX, CHUNK, GAMMA = 4, 16, 6, 8, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def qparams():
    fp = jinit(jschema(CFG), jax.random.PRNGKey(0))
    return jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     enable_clipping=True, tile_k=16)


@pytest.fixture(scope="module")
def tparams(qparams):
    return convert_tree(_np(qparams))


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acc_out", [False, True])
def test_draft_matmul_plain_matches_pallas(acc_out):
    """sparqle_matmul_ref(msb_skip=True) == Pallas _kernel_draft, and the
    CPU wrapper takes the draft without an MSB plane or populations."""
    rng = np.random.default_rng(2)
    m, k, n = 32, 256, 128
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    lsb, msb = (q & 0xF).astype(np.int8), (q >> 4).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    asc = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    wsc = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    pop = np.ones((m // TILE_M, k // TILE_K), np.int32)
    want = np.asarray(jsparqle_matmul(
        jnp.asarray(lsb), jnp.asarray(msb), jnp.asarray(pop), jnp.asarray(w),
        jnp.asarray(asc), jnp.asarray(wsc), bm=TILE_M, bn=128, bk=TILE_K,
        interpret=True, msb_skip=True, acc_out=acc_out))
    wp = tql.pack_int4(_t(w))
    got = ref.sparqle_matmul_ref(_t(lsb), _t(msb), _t(pop), wp, _t(asc),
                                 _t(wsc), acc_out=acc_out, msb_skip=True)
    np.testing.assert_array_equal(got.numpy(), want)
    lean = sparqle_matmul(_t(lsb), None, None, wp, _t(asc), _t(wsc),
                          acc_out=acc_out, msb_skip=True)
    np.testing.assert_array_equal(lean.numpy(), want)
    full = ref.sparqle_matmul_ref(_t(lsb), _t(msb), _t(pop), wp, _t(asc),
                                  _t(wsc), acc_out=acc_out)
    assert not torch.equal(full, got)           # the MSB pass was dropped


def _verify_inputs(seed=5, b=3, t=3, kvh=2, g=2, hd=16, ps=4, n_pages=24,
                   n_s=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, kvh, g, hd)).astype(np.float32)
    kp = rng.integers(-128, 128, (n_pages, ps, kvh, hd // 2)).astype(np.int8)
    vp = rng.integers(-128, 128, (n_pages, ps, kvh, hd // 2)).astype(np.int8)
    ks = rng.uniform(0.01, 0.3, (n_pages, ps, kvh)).astype(np.float32)
    vs = rng.uniform(0.01, 0.3, (n_pages, ps, kvh)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[:b * n_s] + 1).reshape(
        b, n_s).astype(np.int32)
    tables[-1] = 0                                  # inactive: null page
    # window 0 crosses a page boundary (pos 3 -> 3, 4, 5), window 1 ends
    # on the last page of its table
    pos = np.array([ps - 1, n_s * ps - t, 0][:b], np.int32)
    return q, kp, ks, vp, vs, tables, pos


def test_verify_attention_plain_matches_pallas():
    args = _verify_inputs()
    got = ref.kv4_paged_verify_attention_ref(*map(_t, args)).numpy()
    want = np.asarray(jverify_attn(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()
    # window token t is exactly a decode query at pos + t
    q, *rest, pos = map(_t, args)
    for t in range(q.shape[1]):
        single = ref.kv4_paged_decode_attention_ref(q[:, t], *rest, pos + t)
        assert torch.equal(torch.from_numpy(got[:, t]), single)


# ---------------------------------------------------------------------------
# model steps: draft, verify window
# ---------------------------------------------------------------------------

def _tables(*rows):
    t = np.zeros((len(rows), PMAX), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


@pytest.fixture(scope="module")
def prefilled(qparams, tparams):
    """Two sequences prefilled into both pools: A (10 tokens) and B (5),
    then a decode batch [A, B, inactive] with one free page of lookahead."""
    from repro.serving.kv_pool import init_pool_state as jinit_pool
    rng = np.random.default_rng(0)
    jpool = jinit_pool(CFG, JPool(n_pages=NPAGES, page_size=PS))
    tpool = convert_tree(_np(jpool))
    jprefill = jax.jit(JS.make_engine_prefill_chunk(CFG))
    tprefill = TS.make_engine_prefill_chunk(TCFG)
    seqs = [rng.integers(0, CFG.vocab, 10), rng.integers(0, CFG.vocab, 5)]
    tables = [[3, 7, 1, 9], [5, 2, 11]]
    for seq, table in zip(seqs, tables):
        for start in range(0, len(seq), CHUNK):
            n = min(CHUNK, len(seq) - start)
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :n] = seq[start:start + n]
            tbl = _tables(table)
            _, jpool, _ = jprefill(qparams, jpool, jnp.asarray(toks),
                                   jnp.int32(start), jnp.int32(n),
                                   jnp.asarray(tbl))
            tprefill(tparams, tpool, _t(toks), start, n, _t(tbl))
    return (jax.tree_util.tree_map(np.asarray, jpool),
            to_numpy_tree(tpool), _tables(tables[0], tables[1], []),
            np.array([10, 5, 0], np.int32))


def _assert_pools(tpool, jpool):
    jp = _np(jpool)
    tp = to_numpy_tree(tpool)
    for stage in jp["stages"]:
        for key in ("k_q", "v_q"):               # page 0 (null) excluded
            np.testing.assert_array_equal(
                tp["stages"][stage]["p0"][key][:, 1:],
                jp["stages"][stage]["p0"][key][:, 1:])
        for key in ("k_s", "v_s"):
            np.testing.assert_allclose(
                tp["stages"][stage]["p0"][key][:, 1:],
                jp["stages"][stage]["p0"][key][:, 1:], rtol=1e-6)


def test_draft_step_matches_jax(qparams, tparams, prefilled):
    jpool0, tpool0, tbl, pos = prefilled
    jdraft = jax.jit(JS.make_engine_decode(CFG, msb_skip=True,
                                           with_telemetry=False))
    tdraft = TS.make_engine_decode(TCFG, msb_skip=True, with_telemetry=False)
    tpool = convert_tree(tpool0)
    token = np.array([7, 9, 0], np.int32)
    jl, jpool, jt = jdraft(qparams, jax.tree_util.tree_map(jnp.asarray,
                                                           jpool0),
                           jnp.asarray(token), jnp.asarray(pos),
                           jnp.asarray(tbl))
    tl, _, tt = tdraft(tparams, tpool, _t(token), _t(pos), _t(tbl))
    assert not tql.msb_skip_active()            # the scope was left
    assert tt == {} and dict(jt) == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _assert_pools(tpool, jpool)
    # the draft is genuinely sub-precision: it differs from the full step
    full, _, _ = TS.make_engine_decode(TCFG)(
        tparams, convert_tree(tpool0), _t(token), _t(pos), _t(tbl))
    assert not torch.equal(full, tl)


def test_decode_without_telemetry_returns_empty_and_same_logits(
        tparams, prefilled):
    _, tpool0, tbl, pos = prefilled
    token = _t(np.array([7, 9, 0], np.int32))
    with_tel = TM.decode_step_paged(TCFG, tparams, convert_tree(tpool0),
                                    token, _t(pos), _t(tbl))
    lean = TM.decode_step_paged(TCFG, tparams, convert_tree(tpool0), token,
                                _t(pos), _t(tbl), with_telemetry=False)
    assert lean[2] == {}
    assert set(with_tel[2]) == {"sparsity", "layer_sparsity",
                                "layer_wire_bytes", "layer_dense_bytes"}
    assert torch.equal(lean[0], with_tel[0])


def test_verify_window_matches_jax_and_decode_loop(qparams, tparams,
                                                   prefilled):
    jpool0, tpool0, tbl, pos = prefilled
    window = np.array([[7, 17, 42], [9, 1, 4], [0, 0, 0]], np.int32)
    jverify = jax.jit(JS.make_engine_verify_window(CFG))
    tverify = TS.make_engine_verify_window(TCFG)
    tpool = convert_tree(tpool0)
    jl, jpool, jt = jverify(qparams, jax.tree_util.tree_map(jnp.asarray,
                                                            jpool0),
                            jnp.asarray(window), jnp.asarray(pos),
                            jnp.asarray(tbl))
    tl, _, tt = tverify(tparams, tpool, _t(window), _t(pos), _t(tbl))
    assert tl.shape == (3, GAMMA + 1, CFG.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _assert_pools(tpool, jpool)
    jt, tt = _np(jt), to_numpy_tree(tt)
    assert set(tt) == set(jt)
    for key in ("layer_wire_bytes", "layer_dense_bytes"):
        assert tt[key].shape == (CFG.n_layers, 3)
        np.testing.assert_array_equal(tt[key], jt[key])
    for key in ("sparsity", "layer_sparsity"):
        np.testing.assert_allclose(tt[key], jt[key], rtol=1e-6, atol=0)

    # the port's own contract: the window equals γ+1 decode steps,
    # logits and written pool bits
    seq_pool = convert_tree(tpool0)
    decode = TS.make_engine_decode(TCFG)
    for t in range(GAMMA + 1):
        lg, _, _ = decode(tparams, seq_pool, _t(window[:, t]),
                          _t(pos + t), _t(tbl))
        assert torch.equal(tl[:, t], lg), t
    got, want = to_numpy_tree(tpool), to_numpy_tree(seq_pool)
    for key in ("k_q", "k_s", "v_q", "v_s"):
        np.testing.assert_array_equal(got["stages"]["s0"]["p0"][key][:, 1:],
                                      want["stages"]["s0"]["p0"][key][:, 1:])


@pytest.mark.parametrize("qk_norm,dtype", [(True, "float32"),
                                           (False, "bfloat16")])
def test_verify_window_equals_decode_loop_port(qk_norm, dtype):
    """The port's window contract on configs the JAX comparison above
    does not cover: q/k norms (run per window position too) and bf16."""
    from repro_torch.launch.serve import build_served_params
    from repro_torch.serving.kv_pool import init_pool_state
    cfg = TCFG.replace(use_qk_norm=qk_norm, dtype=dtype)
    params = build_served_params(cfg, 3, "cpu", tile_k=16)
    rng = np.random.default_rng(4)
    tbl = _t(_tables([4, 9, 2], [6, 1], []))
    pos = _t(np.array([5, 2, 0], np.int32))
    window = _t(rng.integers(0, cfg.vocab, (3, GAMMA + 1)).astype(np.int32))
    pool0 = init_pool_state(cfg, PoolConfig(n_pages=NPAGES, page_size=PS))
    for key, v in pool0["stages"]["s0"]["p0"].items():   # a used pool
        v.copy_(torch.from_numpy(rng.integers(
            -100, 100, v.shape).astype(np.float32)).to(v.dtype)
            if v.dtype == torch.int8 else
            torch.from_numpy(rng.uniform(0.01, 0.2, v.shape)).to(v.dtype))
    vpool = convert_tree(to_numpy_tree(pool0))
    vl, _, _ = TS.make_engine_verify_window(cfg)(params, vpool, window, pos,
                                                 tbl)
    decode = TS.make_engine_decode(cfg)
    for t in range(GAMMA + 1):
        lg, _, _ = decode(params, pool0, window[:, t].contiguous(), pos + t,
                          tbl)
        assert torch.equal(vl[:, t], lg), t
    got, want = to_numpy_tree(vpool), to_numpy_tree(pool0)
    for key in ("k_q", "k_s", "v_q", "v_s"):
        np.testing.assert_array_equal(got["stages"]["s0"]["p0"][key][:, 1:],
                                      want["stages"]["s0"]["p0"][key][:, 1:])


# ---------------------------------------------------------------------------
# pool truncation and scheduler accounting
# ---------------------------------------------------------------------------

def test_truncate_matches_jax_pool():
    jpool = JPagedKVPool(CFG, JPool(n_pages=10, page_size=4))
    tpool = PagedKVPool(TCFG, PoolConfig(n_pages=10, page_size=4))
    fired = []
    tpool.on_evict = lambda owner, pgs: fired.append(owner)
    calls = [("allocate", 5, "r"), ("allocate", 2, "s"),
             ("truncate", "r", 8), ("truncate", "r", 5),
             ("allocate", 3, "r"), ("truncate", "r", 100),
             ("truncate", "s", 0), ("allocate", 4, "s"),
             ("truncate", "r", 1), ("truncate", "missing", 3)]
    for op, *args in calls:
        assert getattr(tpool, op)(*args) == getattr(jpool, op)(*args), op
        for owner in ("r", "s"):
            assert tpool.pages_of(owner) == jpool.pages_of(owner)
        assert tpool.num_free == jpool.num_free
    assert "s" in tpool._owned
    tpool.truncate("s", 0)
    assert "s" not in tpool._owned                  # no phantom owner
    assert tpool.evictions == 0 and fired == []      # not a preemption
    with pytest.raises(ValueError):
        tpool.truncate("r", -1)


def test_scheduler_lookahead_and_budget_match_jax():
    """Admission, page growth and prefill budget under decode_lookahead=2
    and decode_tokens_per_slot=5, against the JAX scheduler."""
    kw = dict(max_decode_batch=4, token_budget=10, prefill_chunk=8,
              max_pages_per_seq=8, decode_tokens_per_slot=5,
              decode_lookahead=2)
    runs = []
    for pool_cls, cfg, sched_cls, sampling in (
            (JPagedKVPool, CFG, JScheduler, JSampling),
            (PagedKVPool, TCFG, Scheduler, SamplingParams)):
        cfg_cls = JPool if pool_cls is JPagedKVPool else PoolConfig
        sc_cls = JSched if sched_cls is JScheduler else SchedulerConfig
        pool = pool_cls(cfg, cfg_cls(n_pages=32, page_size=4))
        sched = sched_cls(pool, sc_cls(**kw))
        a = sched.submit([1] * 4, sampling(max_new_tokens=4), 0.0)
        pool.allocate(1, a.rid)
        a.prefilled = len(a.context)
        a.slot = sched._free_slots.pop(0)
        a.context.append(9)
        a.out_tokens.append(9)
        sched.to_running(a)
        b = sched.submit([2] * 20, sampling(max_new_tokens=4), 1.0)
        log = []
        for _ in range(3):
            plan = sched.schedule()
            log.append(([r.rid for r in plan.decode],
                        [(r.rid, s, n) for r, s, n in plan.prefill],
                        pool.pages_of(a.rid), pool.pages_of(b.rid)))
            for r, s, n in plan.prefill:
                r.prefilled += n
            a.context.append(9)
            a.out_tokens.append(9)
        with pytest.raises(ValueError):              # 30 + 4 + 2 > 32
            sched.submit([0] * 30, sampling(max_new_tokens=4), 2.0)
        runs.append(log)
    assert runs[0] == runs[1]
    # budget 10 - 1 slot * 5 = 5 caps the first prefill chunk at 5
    assert runs[1][0][1] == [(1, 0, 5)]
    assert len(runs[1][0][2]) == 2                   # pos 4 + 1 + 2 -> 2


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

def _drive(eng, sampling_cls, script, temperature=0.0):
    handles = []
    for steps_before, prompt, gen in script:
        for _ in range(steps_before):
            eng.step()
        handles.append(eng.submit(prompt, sampling_cls(
            max_new_tokens=gen, temperature=temperature, seed=3)))
    eng.run()
    return [list(h.out_tokens) for h in handles], handles


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).tolist()


SCRIPT = [(0, _prompt(1, 11), 7), (0, _prompt(2, 5), 6),
          (2, _prompt(3, 14), 5)]
SPEC_KEYS = ("serving_spec_draft_proposed_total",
             "serving_spec_draft_accepted_total",
             "serving_spec_cycles_total",
             "serving_spec_tokens_emitted_total",
             "serving_engine_steps_total", "serving_pool_evictions_total")


def _engines(qparams, tparams, temperature):
    kw = dict(max_decode_batch=3, token_budget=24, prefill_chunk=8,
              max_pages_per_seq=8)
    pool = dict(n_pages=24, page_size=PS)
    j = JSpeculativeEngine(CFG, qparams, pool_config=JPool(**pool),
                           sched_config=JSched(**kw),
                           spec=JSpecConfig(gamma=GAMMA))
    t = SpeculativeEngine(TCFG, tparams, pool_config=PoolConfig(**pool),
                          sched_config=SchedulerConfig(**kw),
                          spec=SpecConfig(gamma=GAMMA), device="cpu")
    base = Engine(TCFG, tparams, pool_config=PoolConfig(**pool),
                  sched_config=SchedulerConfig(**kw), device="cpu")
    return ((j, _drive(j, JSampling, SCRIPT, temperature)),
            (t, _drive(t, SamplingParams, SCRIPT, temperature)),
            (base, _drive(base, SamplingParams, SCRIPT, temperature)))


def test_spec_engine_greedy_matches_jax_and_base_engine(qparams, tparams):
    (je, (js, jh)), (te, (ts, th)), (be, (bs, _)) = _engines(
        qparams, tparams, 0.0)
    assert ts == js
    assert ts == bs                       # greedy identity with the base
    assert [len(s) for s in ts] == [g for _, _, g in SCRIPT]
    assert te.steps == je.steps
    jr, tr = je.obs.registry, te.obs.registry
    for key in SPEC_KEYS:
        assert tr.value(key) == jr.value(key), key
    assert tr.value("serving_spec_draft_proposed_total") > 0
    ja, ta = je.aggregate_stats(), te.aggregate_stats()
    for key in ("spec_gamma", "spec_acceptance_rate",
                "spec_tokens_per_step", "pool_evictions",
                "pool_pages_free"):
        assert ta[key] == ja[key], key
    assert ta["wire_bytes_total"] == ja["wire_bytes_total"]
    assert te.wire_tokens == je.wire_tokens
    for a, b in zip(th, jh):
        sa, sb = a.stats(), b.stats()
        for key in ("spec_acceptance_rate", "spec_tokens_per_step",
                    "draft_tokens", "wire_tokens"):
            assert sa[key] == sb[key], key
    assert te.pool.num_free == te.pool.n_usable_pages


def test_spec_engine_sampled_streams_match_jax(qparams, tparams):
    """Temperature 0.8, fixed seeds: rejection sampling draws the same
    tokens in both packages (the host RNG is numpy in both)."""
    (je, (js, _)), (te, (ts, th)), _ = _engines(qparams, tparams, 0.8)
    assert ts == js
    for h, (_, _, gen) in zip(th, SCRIPT):
        assert h.done and h.n_generated == gen
        assert h.draft_accepted <= h.draft_proposed
        assert h.spec_emitted == gen - 1     # all but the prefill token
    assert te.pool.num_free == te.pool.n_usable_pages


# ---------------------------------------------------------------------------
# the bench's Poisson trace: recorded counters
# ---------------------------------------------------------------------------

def _bench_drive(eng, trace):
    """``bench_serving._drive`` with the port's SamplingParams."""
    handles, i, step = [], 0, 0
    while i < len(trace) or eng.sched.has_work():
        while i < len(trace) and trace[i][0] <= step:
            _, prompt, gen = trace[i]
            handles.append(eng.submit(prompt,
                                      SamplingParams(max_new_tokens=gen)))
            i += 1
        if eng.sched.has_work():
            eng.step()
        step += 1
    return handles


def test_bench_trace_counters_match_baseline():
    """The port's Engine and SpeculativeEngine (γ=2) through the bench's
    Poisson trace (8 requests, 2 Hz, seed 0) on the bench's draft-
    friendly model give the counters recorded in serving.json."""
    fp = B.draft_friendly_params(B.BENCH_CFG, seed=0)
    qp = jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                   mode="sparqle", enable_clipping=True, tile_k=16)
    params = convert_tree(_np(qp))
    cfg = ModelConfig(**dataclasses.asdict(B.BENCH_CFG))
    trace = B._poisson_trace(np.random.default_rng(0), 8, 2.0)
    kw = dict(pool_config=PoolConfig(n_pages=48, page_size=16),
              sched_config=SchedulerConfig(max_decode_batch=8,
                                           token_budget=96, prefill_chunk=32,
                                           max_pages_per_seq=8),
              device="cpu")
    base = Engine(cfg, params, **kw)
    bh = _bench_drive(base, trace)
    agg = base.aggregate_stats()
    assert agg["steps"] == 57
    assert sum(h.n_generated for h in bh) == 63
    assert agg["pool_evictions"] == 0
    assert round(sum(agg["layer_wire_bytes_per_token"]), 3) == 119.074

    spec = SpeculativeEngine(cfg, params, spec=SpecConfig(gamma=2), **kw)
    sh = _bench_drive(spec, trace)
    sagg = spec.aggregate_stats()
    assert sagg["steps"] == 35
    assert round(sagg["spec_acceptance_rate"], 4) == 0.7955
    assert sagg["spec_tokens_per_step"] == pytest.approx(2.2, abs=1e-12)
    assert [h.out_tokens for h in sh] == [h.out_tokens for h in bh]

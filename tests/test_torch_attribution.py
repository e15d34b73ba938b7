"""Port parity, per-step attribution and the serve's surface.

  * the roofline and drift math through ``register_cost`` on a synthetic
    clock: the port's gauges, counters and trace instants equal the JAX
    package's ``repro.obs.attribution`` on the same costs and peaks;
  * the FLOPs ``launch/step_cost.py`` counts from the step's shapes equal
    JAX's attributed ``serving_step_attr_flops`` (from the compiled HLO)
    on ``tests/test_attribution.py``'s ``tiny-attr`` engine in all four
    phases (prefill, decode, draft, verify), with the same tokens and
    calls a step; the bytes equal a closed form written here and lie
    within a stated margin above the bytes of the tensors a decode must
    read; a KV2 engine's decode counted at the share of KV2 pages its
    decodes read; the MoE FFN counted as stated;
  * a run joined after ``engine.run()``: roofline and latency drift set,
    wire drift within 5% of Eq. 1, the snapshot valid;
  * ``Engine.stream`` yields the JAX engine's greedy stream for one
    request among others in flight;
  * ``serve --slo --attribute --metrics-out`` on the CPU smoke config:
    the snapshot validates, the SLO and closing reports are in the
    summary, and the two flags are refused with ``--legacy``; the closing
    report's cost-model prediction is JAX's ``evaluate_model`` at the
    measured sparsity, which is JAX's on the same params within 1e-2.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.core import costmodel as JCM
from repro.core.qlinear import quantize_model_params as jquantize
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.obs import Observability as JObs
from repro.obs.attribution import StepAttribution as JAttr
from repro.obs.attribution import StepCost as JCost
from repro.serving import Engine as JEngine
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro.serving import SpecConfig as JSpec
from repro.serving import SpeculativeEngine as JSpecEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.core import costmodel as TCM
from repro_torch.launch.step_cost import step_cost
from repro_torch.obs import Observability
from repro_torch.obs.attribution import StepAttribution, StepCost
from repro_torch.obs.validate import validate_attribution, validate_snapshot
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig, SpecConfig,
                                 SpeculativeEngine)

CFG = JConfig(name="tiny-attr", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
POOL = dict(n_pages=32, page_size=4)
SCHED = dict(max_decode_batch=4, token_budget=64, prefill_chunk=8,
             max_pages_per_seq=8)
PHASES = ("prefill", "decode", "draft", "verify")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class FakeClock:
    """Deterministic monotonic clock: every read advances by ``dt``."""

    def __init__(self, dt=0.001):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def trees():
    fp = jinit(jschema(CFG), jax.random.PRNGKey(0))
    qp = jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                   mode="sparqle", enable_clipping=True, tile_k=16)
    return qp, convert_tree(jax.tree_util.tree_map(np.asarray, qp))


@pytest.fixture(scope="module")
def jax_attr(trees):
    """JAX's attribution of its speculative engine (all four phases)."""
    eng = JSpecEngine(CFG, trees[0], spec=JSpec(gamma=2),
                      pool_config=JPool(**POOL), sched_config=JSched(**SCHED))
    attr = eng.attribute_steps()
    return {p: attr.cost(p) for p in attr.phases()}


def _engine(tree, gamma=0, clock=None, slos=None):
    kw = dict(pool_config=PoolConfig(**POOL),
              sched_config=SchedulerConfig(**SCHED), device="cpu", slos=slos)
    if clock is not None:
        kw["clock"] = clock
    if gamma:
        return SpeculativeEngine(TCFG, tree, spec=SpecConfig(gamma=gamma),
                                 **kw)
    return Engine(TCFG, tree, **kw)


# ---------------------------------------------------------------------------
# the drift math on a synthetic clock, against JAX's
# ---------------------------------------------------------------------------

def _seamed():
    """(jax obs, jax attr, port obs, port attr) on the same decode cost and
    the same card peaks (the port's H100 defaults handed to JAX's)."""
    peaks = dict(peak_flops=TCM.HardwareConfig().peak_flops,
                 hbm_bw=TCM.HardwareConfig().hbm_bw)
    jo, to = JObs(clock=FakeClock()), Observability(clock=FakeClock())
    ja = JAttr(jo, hw=JCM.HardwareConfig(**peaks))
    ta = StepAttribution(to)
    cost = dict(phase="decode", flops=1e9, hbm_bytes=2e9,
                coll_bytes={"total": 0.0}, tokens_per_step=8)
    ja.register_cost(JCost(**cost), predict_seconds=lambda s: 0.010)
    ta.register_cost(StepCost(**cost), predict_seconds=lambda s: 0.010)
    return jo, ja, to, ta


def _same(jo, to):
    """Equal metric families, series and values (help texts differ: the
    port's count shapes where JAX's walk HLO)."""
    def values(snap):
        return {k: {f: v for f, v in e.items() if f != "help"}
                for k, e in snap.items()}
    assert values(to.registry.snapshot()) == values(jo.registry.snapshot())
    assert ([(e["name"], e["args"]) for e in to.tracer._events]
            == [(e["name"], e["args"]) for e in jo.tracer._events])


def test_roofline_join_math_matches_jax():
    jo, ja, to, ta = _seamed()
    for a in (ja, ta):
        a.observe_runtime("decode", 0.020)
    _same(jo, to)
    r = to.registry
    assert r.value("serving_roofline_compute_util_ratio",
                   phase="decode") == 1e9 / 0.020 / 1979e12
    assert r.value("serving_roofline_memory_util_ratio",
                   phase="decode") == 2e9 / 0.020 / 3.35e12
    assert r.value("serving_costmodel_latency_drift_ratio",
                   phase="decode") == pytest.approx(2.0)
    assert ta.summary() == ja.summary()


@pytest.mark.parametrize("seconds,events", [
    ((0.020, 0.030), 0), ((0.020, 0.030, 0.050), 1),
    ((0.020, 0.050, 0.060), 1), ((0.020, 0.050, 0.060, 0.020, 0.002), 2)])
def test_latency_drift_edge_triggered_matches_jax(seconds, events):
    jo, ja, to, ta = _seamed()
    for s in seconds:
        ja.observe_runtime("decode", s)
        ta.observe_runtime("decode", s)
        _same(jo, to)
    assert to.registry.value("serving_costmodel_drift_events_total",
                             phase="decode") == events


def test_wire_drift_edge_triggered_matches_jax():
    jo, ja, to, ta = _seamed()
    for measured, predicted in ((100.0, 100.5), (130.0, 100.0),
                                (135.0, 100.0), (101.0, 100.0),
                                (70.0, 100.0), (1.0, 0.0)):
        ja.observe_wire(measured, predicted)
        ta.observe_wire(measured, predicted)
        _same(jo, to)
    assert to.registry.value("serving_costmodel_drift_events_total",
                             phase="wire") == 2


def test_attribute_counts_once_per_phase(trees):
    to = Observability(clock=FakeClock())
    ta = StepAttribution(to)
    calls = []

    def count():
        calls.append(1)
        return step_cost(TCFG, trees[1], "draft", rows=4, table_tokens=32)

    c = ta.attribute("draft", count, tokens_per_step=8, calls_per_step=2)
    assert ta.attribute("draft", count, tokens_per_step=8) is c
    assert len(calls) == 1
    assert c.calls_per_step == 2 and c.compile_seconds == 0.001
    one = count()
    assert c.flops == 2 * one.flops and c.hbm_bytes == 2 * one.hbm_bytes
    hist = to.registry.get("serving_attr_compile_seconds")
    assert hist.count(phase="draft") == 1


# ---------------------------------------------------------------------------
# FLOPs against JAX's HLO attribution, bytes against a closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", PHASES)
def test_step_flops_equal_jax_attribution(trees, jax_attr, phase):
    eng = _engine(trees[1], gamma=2)
    got = eng.attribute_steps().cost(phase)
    want = jax_attr[phase]
    assert got.flops == want.flops
    assert (got.tokens_per_step, got.calls_per_step) == \
        (want.tokens_per_step, want.calls_per_step)
    assert got.coll_bytes["total"] == want.coll_bytes["total"] == 0


def test_reference_flops_are_the_stated_ones(jax_attr):
    """The numbers the port is held to (JAX 0.9 on the CPU)."""
    assert {p: c.flops for p, c in jax_attr.items()} == {
        "prefill": 688_128, "decode": 393_216, "draft": 425_984,
        "verify": 1_179_648}


def _closed_form_bytes(m, seqs, keys, new_tokens, head_rows, passes,
                       chunk_kv=0):
    """tiny-attr at f32: x 4 B an element, unpacked planes, every
    projection clipped (its mask read), KV4 pages of hd 8."""
    xb, hd, kvh, heads, d, v = 4, 8, 2, 4, 32, 128

    def lin(m, k, n):
        pops = -(-m // 16) * -(-k // 128) * 4
        enc = m * k * xb + k + m * 4 + 2 * m * k + pops
        mm = m * k * passes + k * n // 2 + m * 4 + n * 4 + m * n * 4
        return enc + mm

    per_layer = (lin(m, d, 32) + 2 * lin(m, d, 16) + lin(m, 32, d)
                 + 2 * lin(m, d, 64) + lin(m, 64, d))
    per_layer += (2 * m * heads * hd * xb + seqs * keys * kvh * 2 * (
        hd // 2 + 4) + new_tokens * kvh * 2 * (hd // 2 + 4)
        + chunk_kv * 2 * kvh * hd * xb)
    return 2 * per_layer + m * d * 4 + lin(head_rows, d, v)


@pytest.mark.parametrize("phase,rows,window,expect", [
    ("prefill", 8, 1, dict(m=8, seqs=1, keys=32, new_tokens=8, head_rows=1,
                           passes=2, chunk_kv=8)),
    ("decode", 4, 1, dict(m=4, seqs=4, keys=32, new_tokens=4, head_rows=4,
                          passes=2)),
    ("draft", 4, 1, dict(m=4, seqs=4, keys=32, new_tokens=4, head_rows=4,
                         passes=1)),
    ("verify", 4, 3, dict(m=12, seqs=4, keys=32, new_tokens=12,
                          head_rows=12, passes=2))])
def test_step_bytes_equal_closed_form(trees, phase, rows, window, expect):
    got = step_cost(TCFG, trees[1], phase, rows=rows, table_tokens=32,
                    window=window)
    assert got.hbm_bytes == _closed_form_bytes(**expect)


def test_kv2_pages_count_at_their_width(trees):
    """Every table token read from a KV2 page saves hd/4 bytes of K and
    of V a KV head: (hd/2 + 4) - (hd/4 + 4) twice."""
    kv4 = step_cost(TCFG, trees[1], "decode", rows=4, table_tokens=32)
    kv2 = step_cost(TCFG, trees[1], "decode", rows=4, table_tokens=32,
                    kv2_share=1.0)
    assert kv4.hbm_bytes - kv2.hbm_bytes == 2 * 4 * 32 * 2 * 2 * (8 // 4)
    assert kv2.flops == kv4.flops


def test_kv2_engine_counts_its_decodes_kv2_share(trees):
    """A KV2-armed engine demoting every cold page: at the join its
    decode is counted again at the share of table entries its decodes
    read from KV2 pages — the share of the tier tables the decode step
    was handed — each such table token hd/4 bytes of K and of V a KV head
    below a KV4 one; FLOPs, tokens and calls unchanged."""
    eng = Engine(TCFG, trees[1], pool_config=PoolConfig(
        **POOL, kv2_pages=24, demote_after_steps=1, demote_min_sparsity=0.0),
        sched_config=SchedulerConfig(**SCHED), device="cpu")
    attr = eng.attribute_steps()
    kv4 = attr.cost("decode")
    seen, decode = [], eng._decode_fn

    def spy(*args):
        seen.append(args[-1].numpy().copy())       # the tier table
        return decode(*args)

    eng._decode_fn = spy
    rng = np.random.RandomState(6)
    for n in (9, 13, 10):
        eng.submit(rng.randint(0, CFG.vocab, size=n).tolist(),
                   SamplingParams(max_new_tokens=8))
    eng.run()
    eng.metrics_snapshot()
    tiers = np.stack(seen)
    share = tiers.sum() / tiers.size
    assert 0 < share < 1 and eng.kv2_table_share() == share
    got = attr.cost("decode")
    assert eng.obs.registry.value("serving_step_attr_hbm_bytes",
                                  phase="decode") == got.hbm_bytes
    # 2 layers x 4 slots x 32 table tokens x 2 KV heads x (K, V) x hd/4
    assert kv4.hbm_bytes - got.hbm_bytes == pytest.approx(
        2 * 4 * 32 * 2 * 2 * (8 // 4) * share, rel=1e-12)
    assert (got.flops, got.tokens_per_step, got.calls_per_step) == \
        (kv4.flops, kv4.tokens_per_step, kv4.calls_per_step)


# Wide enough that a decode row's activations are a few per cent of the
# weights it reads: one slot's activation, plane, output, q, attention
# output, new K/V, embedding-row and logit traffic is 4.7% above the
# resident bytes here (granite-8b at 8 slots: about 3%).
WIDE = ModelConfig(name="wide-attr", family="transformer", n_layers=2,
                   d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
                   d_ff=1024, vocab=512, dtype="float32")
WIDE_MARGIN = 0.06


def test_decode_bytes_against_resident_tensors():
    """Held to a measure outside step_cost's rules: a decode step moves at
    least the bytes of the tensors it must read (``chip_smoke``'s
    ``resident_decode_bytes``: each projection's weight, scales and
    mask, the tied head's table, the pool's KV over every slot's table,
    summed from the tensors and the pool's slabs) and at most WIDE_MARGIN
    more. chip_smoke phase 14 holds granite-8b's decode to the same."""
    from chip_smoke import resident_decode_bytes
    from repro_torch.launch.serve import build_served_params, make_engine
    tree = build_served_params(WIDE, 0, "cpu", tile_k=16)
    eng = make_engine(WIDE, tree, batch=1, prompt_len=24, gen=8,
                      page_size=8, decode_slots=1, device="cpu",
                      attribute=True)
    got = eng._attr.cost("decode").hbm_bytes
    least = resident_decode_bytes(eng)
    assert least <= got <= least * (1 + WIDE_MARGIN)


def test_spec_decode_row_is_marked_as_the_cycle(trees):
    """The speculative engine's timed ``decode`` is its whole draft +
    verify cycle: the serve's report marks that row, and no other."""
    from repro_torch.launch.serve import attribution_report
    for gamma, cycle in ((0, set()), (2, {"decode"})):
        eng = _engine(trees[1], gamma=gamma)
        eng.attribute_steps()
        rows = attribution_report(eng)
        assert {p for p, row in rows.items() if row["cycle"]} == cycle


def test_moe_and_dense_mode_flops_closed_form():
    """A MoE layer: the router's f32 product, the routed experts at E x
    capacity rows (capacity of the step's whole batch), the shared
    experts; the dense mode one pass a projection."""
    from repro_torch.launch.serve import build_served_params
    cfg = ModelConfig(name="tiny-moe-serve", family="moe", n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                      d_ff=64, vocab=64, dtype="float32", n_experts=4,
                      top_k=2, moe_every=2, moe_d_ff=32, n_shared_experts=1,
                      router_type="softmax")
    tree = build_served_params(cfg, 0, "cpu", tile_k=16)
    got = step_cost(cfg, tree, "decode", rows=4, table_tokens=16)
    attn = 2 * 4 * (32 * 32 + 2 * 32 * 16 + 32 * 32) * 2 \
        + 4 * 4 * 8 * 4 * 16
    dense_ffn = 2 * 4 * (2 * 32 * 64 + 64 * 32) * 2
    cap = max(1, 4 * 2 // 4)
    shared_n = tree["stages"]["s0"]["p1"]["moe"]["w_shared_gate"].w.q.shape[-1]
    moe = (2 * 4 * 32 * 4 + 4 * 2 * cap * (2 * 32 * 32 + 32 * 32) * 2
           + 2 * 4 * (2 * 32 * shared_n + shared_n * 32) * 2)
    head = 2 * 4 * 32 * 64 * 2
    assert got.flops == 2 * attn + dense_ffn + moe + head
    dense = build_served_params(TCFG, 0, "cpu", tile_k=16, mode="dense")
    assert step_cost(TCFG, dense, "decode", rows=4,
                     table_tokens=32).flops == 425_984 // 2


# ---------------------------------------------------------------------------
# the runtime join, Engine.stream, the serve CLI
# ---------------------------------------------------------------------------

def test_runtime_join_after_real_run(trees):
    eng = _engine(trees[1], clock=FakeClock(dt=0.001))
    attr = eng.attribute_steps()
    assert eng.attribute_steps() is attr
    assert attr.hw == TCM.HardwareConfig()      # the CPU: SXM peaks
    for i in range(3):
        eng.submit([1, 2, 3, 4 + i], SamplingParams(max_new_tokens=3))
    eng.run()
    snap = eng.metrics_snapshot()
    r = eng.obs.registry
    for phase in ("prefill", "decode"):
        assert r.value("serving_roofline_compute_util_ratio",
                       phase=phase) > 0
        assert r.value("serving_roofline_memory_util_ratio",
                       phase=phase) > 0
        assert r.value("serving_costmodel_latency_drift_ratio",
                       phase=phase) > 0
    assert abs(r.value("serving_costmodel_wire_drift_ratio") - 1.0) < 0.05
    assert validate_attribution(snap, require=True) == []
    assert validate_snapshot(snap) == []


def test_engine_stream_matches_jax(trees):
    """One request streamed while two others are in flight: the tokens
    yielded are JAX's stream of it, and its ``out_tokens``."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, CFG.vocab, size=n).tolist() for n in (9, 6, 11)]
    streams = []
    for eng, sp in ((JEngine(CFG, trees[0], pool_config=JPool(**POOL),
                             sched_config=JSched(**SCHED)), JSampling),
                    (_engine(trees[1]), SamplingParams)):
        hs = [eng.submit(p, sp(max_new_tokens=n))
              for p, n in zip(prompts, (6, 4, 5))]
        got = list(eng.stream(hs[1]))
        assert got == hs[1].out_tokens and len(got) == 4
        eng.run()
        streams.append([got] + [list(h.out_tokens) for h in hs])
    assert streams[1] == streams[0]


def test_serve_slo_attribute_metrics_out(tmp_path):
    from repro_torch.launch import serve
    out = tmp_path / "m.json"
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch",
            "4", "--prompt-len", "13", "--gen", "5", "--page-size", "8"]
    r = serve.main(args + ["--slo", "ttft:p95<60,tpot:p50<1e-6", "--slo",
                           "queue_depth:p50<4", "--attribute",
                           "--metrics-out", str(out)])
    snap = json.loads(out.read_text())
    assert validate_snapshot(snap) == []
    assert validate_attribution(snap, require=True) == []
    slo = {rep["slo"]: rep for rep in r["slo"]}
    assert set(slo) == {"ttft:p95<60", "tpot:p50<1e-6", "queue_depth:p50<4"}
    assert slo["ttft:p95<60"]["violations"] == 0
    assert slo["tpot:p50<1e-6"]["violations"] >= 1
    assert set(r["attribution"]) == {"prefill", "decode"}
    for row in r["attribution"].values():
        assert row["steps"] > 0 and row["memory_util"] > 0
    assert 0.0 <= r["hidden_sparsity"] <= 1.0
    assert set(r["costmodel"]) >= {"ttft_latency_pct", "tpot_latency_pct"}
    plain = serve.main(args)
    assert plain["streams"] == r["streams"]
    assert plain["slo"] is None and plain["attribution"] is None
    for flag in (["--slo", "ttft:p95<1"], ["--attribute"]):
        with pytest.raises(SystemExit, match="--legacy"):
            serve.main(args + ["--legacy"] + flag)
    legacy = serve.main(args + ["--legacy"])
    assert legacy["hidden_sparsity"] == r["hidden_sparsity"]


def test_closing_report_matches_jax(trees):
    """On the same params and prompts: the hidden stream's MSB4 sparsity
    within 1e-2 of JAX's ``forward_hidden`` (f32 attention sums in
    another order can move an int8 rounding), and the cost-model
    prediction JAX's ``evaluate_model`` at the port's sparsity."""
    import jax.numpy as jnp
    from repro.core.quantize import quantize_activations
    from repro.core.sparqle import subprecision_sparsity
    from repro.models import model as JM
    from repro_torch.launch.serve import closing_report
    rng = np.random.RandomState(5)
    prompts = rng.randint(0, CFG.vocab, size=(3, 12)).tolist()
    got = closing_report(TCFG, trees[1], prompts, "cpu")
    hidden = JM.forward_hidden(CFG, trees[0],
                               {"tokens": jnp.asarray(prompts, jnp.int32)})
    q = quantize_activations(hidden.reshape(-1, hidden.shape[-1])).q
    assert abs(got["hidden_sparsity"] - float(subprecision_sparsity(q))) \
        <= 1e-2
    lm = JCM.LMShape(CFG.name, CFG.n_layers, CFG.d_model, CFG.n_heads,
                     CFG.n_kv_heads, CFG.d_ff, CFG.vocab, w_bits=4)
    assert got["costmodel"] == JCM.evaluate_model(
        lm, got["hidden_sparsity"], prefill_tokens=36,
        decode_batch=3).improvements()

"""Port parity, SLOs and validators: ``repro_torch.obs.slo`` and
``repro_torch.obs.validate`` against the JAX package's ``repro.obs.slo``
and ``repro.obs.validate`` on the cases of ``tests/test_attribution.py``
(nearest-rank windows, spec parsing, a spike that fires and re-arms,
``min_samples``) driven through both packages on one synthetic clock,
with equal gauges, counters, reports and trace instants; the port's
engine silent on a generous baseline and firing on a tight target; the
three validators giving equal problem lists on the same snapshots and
traces, valid ones and broken ones."""
import copy
import dataclasses

import pytest

from repro.obs import Observability as JObs
from repro.obs import slo as jslo
from repro.obs import validate as jval
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import build_served_params
from repro_torch.obs import Observability
from repro_torch.obs import slo as tslo
from repro_torch.obs import validate as tval
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig)

CFG = ModelConfig(name="tiny-attr", family="transformer", n_layers=2,
                  d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab=128, dtype="float32")


class FakeClock:
    """Deterministic monotonic clock: every read advances by ``dt``."""

    def __init__(self, dt=0.001):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _both(slos_spec):
    """(jax monitor, jax obs, port monitor, port obs) over the same SLOs,
    each package's SLO dataclass built from the same fields."""
    jo, to = JObs(clock=FakeClock()), Observability(clock=FakeClock())
    jm = jslo.SLOMonitor([jslo.SLO(**s) for s in slos_spec], jo)
    tm = tslo.SLOMonitor([tslo.SLO(**s) for s in slos_spec], to)
    return jm, jo, tm, to


def _assert_same_state(jo, to, jm, tm):
    assert to.registry.snapshot() == jo.registry.snapshot()
    assert repr(tm.report()) == repr(jm.report())     # NaN-safe equality
    assert tm.violations() == jm.violations()
    assert ([(e["name"], e["args"]) for e in to.tracer._events]
            == [(e["name"], e["args"]) for e in jo.tracer._events])


@pytest.mark.parametrize("values,checks", [
    ([5.0, 1.0, 3.0, 2.0, 4.0],
     [(50, 3.0), (95, 5.0), (20, 1.0), (100, 5.0)]),
    ([0.25, 0.5, 0.125], [(1, 0.125), (50, 0.25), (66.7, 0.5)]),
])
def test_sliding_window_nearest_rank_matches_jax(values, checks):
    jw, tw = jslo.SlidingWindow(maxlen=100), tslo.SlidingWindow(maxlen=100)
    for v in values:
        jw.observe(v)
        tw.observe(v)
    for q, want in checks:
        assert tw.percentile(q) == jw.percentile(q) == want
    assert tw.over_fraction(values[2]) == jw.over_fraction(values[2])


def test_sliding_window_evicts_oldest_like_jax():
    jw, tw = jslo.SlidingWindow(maxlen=3), tslo.SlidingWindow(maxlen=3)
    for v in [10.0, 20.0, 30.0, 40.0]:
        jw.observe(v)
        tw.observe(v)
    assert (len(tw), tw.total) == (len(jw), jw.total) == (3, 4)
    assert tw.percentile(50) == jw.percentile(50) == 30.0
    for w in (jw, tw):
        with pytest.raises(ValueError):
            w.observe(float("nan"))


@pytest.mark.parametrize("spec", ["ttft:p95<0.25", "queue_depth:p50<4",
                                  "tpot:p99.9<1e-3", " tpot:p50<2 "])
def test_parse_slo_matches_jax(spec):
    j, t = jslo.parse_slo(spec, window=16), tslo.parse_slo(spec, window=16)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.unit == j.unit


@pytest.mark.parametrize("bad", ["nonsense", "latency:p95<1", "ttft:p0<1",
                                 "ttft:p95<inf"])
def test_parse_slo_rejects_like_jax(bad):
    for mod in (jslo, tslo):
        with pytest.raises(ValueError):
            mod.parse_slo(bad)


def test_parse_slo_list_matches_jax():
    text = "ttft:p95<1,tpot:p99<0.5,,queue_depth:p50<3"
    assert ([dataclasses.asdict(s) for s in tslo.parse_slo_list(text)]
            == [dataclasses.asdict(s) for s in jslo.parse_slo_list(text)])
    assert tslo.parse_slo_list("") == jslo.parse_slo_list("") == []
    for mod in (jslo, tslo):
        with pytest.raises(ValueError):
            mod.SLO(name="bad", signal="ttft", target=1.0, percentile=0.0)


def test_slo_spike_fires_and_rearms_like_jax():
    """A healthy baseline, an injected spike (fires once), recovery and a
    second spike (fires again): the same gauges, counters, report and
    trace instants in both packages after every phase."""
    jm, jo, tm, to = _both([dict(name="tpot", signal="tpot", target=0.1,
                                 percentile=95.0, window=8)])
    for value, n in ((0.01, 8), (0.5, 8), (0.01, 8), (0.5, 8)):
        for _ in range(n):
            jm.observe("tpot", value)
            tm.observe("tpot", value)
        _assert_same_state(jo, to, jm, tm)
    r = to.registry
    assert r.value("serving_slo_violations_total", slo="tpot") == 2.0
    assert r.value("serving_slo_burn_rate", slo="tpot") > 1.0
    assert len([e for e in to.tracer._events
                if e["name"] == "slo_violation"]) == 2


def test_slo_min_samples_gates_judgement_like_jax():
    jm, jo, tm, to = _both([dict(name="q", signal="queue_depth", target=1.0,
                                 window=16, min_samples=4)])
    for _ in range(3):
        jm.observe("queue_depth", 50.0)
        tm.observe("queue_depth", 50.0)
    _assert_same_state(jo, to, jm, tm)
    assert to.registry.value("serving_slo_compliant", slo="q") == 1.0
    jm.observe("queue_depth", 50.0)
    tm.observe("queue_depth", 50.0)
    _assert_same_state(jo, to, jm, tm)
    rep = tm.report()[0]
    assert rep["violating"] and rep["violations"] == 1


def test_slo_duplicate_names_refused_like_jax():
    spec = [dict(name="a", signal="ttft", target=1.0)] * 2
    for mod, obs in ((jslo, JObs()), (tslo, Observability())):
        with pytest.raises(ValueError, match="duplicate"):
            mod.SLOMonitor([mod.SLO(**s) for s in spec], obs)


@pytest.fixture(scope="module")
def served():
    return build_served_params(CFG, 0, "cpu", tile_k=16)


def _engine(params, slos, attribute=False):
    eng = Engine(CFG, params, pool_config=PoolConfig(n_pages=32, page_size=4),
                 sched_config=SchedulerConfig(max_decode_batch=4,
                                              token_budget=64,
                                              prefill_chunk=8,
                                              max_pages_per_seq=8),
                 clock=FakeClock(dt=0.001), device="cpu", slos=slos)
    if attribute:
        eng.attribute_steps()
    return eng


def test_engine_slos_silent_on_baseline_run(served):
    eng = _engine(served, tslo.parse_slo_list(
        "ttft:p95<60,tpot:p95<60,queue_depth:p50<64"))
    for i in range(3):
        eng.submit([1, 2, 3, 4 + i], SamplingParams(max_new_tokens=3))
    eng.run()
    assert all(v == 0 for v in eng.slo.violations().values())
    assert all(not rep["violating"] for rep in eng.slo.report())
    assert all(rep["samples"] > 0 for rep in eng.slo.report())


def test_engine_slo_fires_on_tight_target(served):
    eng = _engine(served, [tslo.SLO(name="tight", signal="tpot",
                                    target=1e-6, window=8)])
    h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
    eng.run()
    assert eng.slo.violations()["tight"] >= 1
    assert "slo_violation" in [e["name"] for e in eng.obs.tracer._events]
    assert len(h.out_tokens) == 4


def test_engine_without_slos_has_no_monitor(served):
    assert _engine(served, None).slo is None


# ---------------------------------------------------------------------------
# validators: equal problem lists on the same artifacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(served):
    """A real snapshot of the port's engine: attributed, SLO-armed, run."""
    eng = _engine(served, tslo.parse_slo_list("ttft:p95<60,tpot:p50<1e-6"),
                  attribute=True)
    for i in range(3):
        eng.submit([1, 2, 3, 4 + i], SamplingParams(max_new_tokens=3))
    eng.run()
    return eng.metrics_snapshot(), eng.obs.tracer


def _broken_snapshots(snap):
    out = {"valid": snap, "not-a-dict": [1, 2]}
    s = copy.deepcopy(snap)
    s["Bad-Name"] = s.pop("serving_engine_steps_total")
    out["bad-name"] = s
    s = copy.deepcopy(snap)
    s["serving_ttft_seconds"]["unit"] = ""
    s["serving_ttft_seconds"]["series"][0]["bucket_counts"][0] += 1
    out["unit-and-buckets"] = s
    s = copy.deepcopy(snap)
    del s["serving_step_attr_tokens"]
    out["attr-incomplete"] = s
    s = copy.deepcopy(snap)
    s["serving_step_attr_hbm_bytes"]["series"].pop()
    s["serving_roofline_memory_util_ratio"]["series"][0]["value"] = -1.0
    s["serving_costmodel_wire_drift_ratio"]["series"][0]["value"] = 0.0
    out["attr-values"] = s
    s = copy.deepcopy(snap)
    s["serving_slo_compliant"]["series"][0]["value"] = 0.5
    s["serving_slo_burn_rate"]["series"][0]["value"] = float("inf")
    del s["serving_slo_target"]
    out["slo-family"] = s
    s = {k: v for k, v in snap.items()
         if not k.startswith(("serving_step_attr", "serving_roofline",
                              "serving_costmodel", "serving_attr"))}
    out["unattributed"] = s
    return out


@pytest.mark.parametrize("case", ["valid", "not-a-dict", "bad-name",
                                  "unit-and-buckets", "attr-incomplete",
                                  "attr-values", "slo-family",
                                  "unattributed"])
def test_validators_match_jax(snapshot, case):
    snap = _broken_snapshots(snapshot[0])[case]
    got = tval.validate_snapshot(snap)
    assert got == jval.validate_snapshot(snap)
    for require in (False, True):
        got_a = tval.validate_attribution(snap, require=require)
        assert got_a == jval.validate_attribution(snap, require=require)
    if case == "valid":
        assert got == [] and got_a == []
    elif case != "not-a-dict":
        assert got or got_a


def test_chrome_trace_validator_matches_jax(snapshot, tmp_path):
    import json
    path = tmp_path / "trace.json"
    snapshot[1].export_chrome(str(path))
    trace = json.loads(path.read_text())
    assert tval.validate_chrome_trace(trace) == []
    broken = copy.deepcopy(trace)
    broken["traceEvents"] += [
        {"name": "", "ph": "X", "pid": 0, "tid": 0, "ts": 1.0, "dur": -1},
        {"name": "x", "ph": "Q", "pid": 0, "tid": 0},
        {"name": "y", "ph": "i", "pid": "0", "tid": 0, "ts": float("nan"),
         "args": []}, 7]
    for t in (trace, broken, {"traceEvents": 3}, []):
        assert tval.validate_chrome_trace(t) == jval.validate_chrome_trace(t)
    assert len(tval.validate_chrome_trace(broken)) >= 6

"""Per-step performance attribution: a step's counted work x its measured
time (torch twin of ``repro.obs.attribution``, with the same metric
names and drift defaults).

The JAX package lowers each jitted serving step and walks its optimized
HLO. The port has no HLO, and its hand-written kernels are opaque to
torch's counters, so it counts each step's work from the step's shapes
(``launch/step_cost.py``): ``Engine.attribute_steps()`` hands
:meth:`StepAttribution.attribute` a zero-argument count for each phase
(prefill / decode, plus draft / verify on the speculative engine), and
the per-step FLOPs, HBM bytes and per-kind collective bytes land in the
metrics registry:

  * ``serving_step_attr_flops{phase=}``        — dot FLOPs (and integer
    ops) per engine step, per rank (draft scaled by its γ calls a step),
  * ``serving_step_attr_hbm_bytes{phase=}``    — a floor on the step's
    HBM traffic: each kernel's inputs read once and its outputs written
    once (not JAX's operand-and-result proxy, which counts the whole
    pool state at every op),
  * ``serving_step_attr_coll_bytes{phase=,kind=}`` — collective payload,
  * ``serving_step_attr_tokens{phase=}``       — tokens one step moves,
  * ``serving_attr_compile_seconds{phase=}``   — how long the count
    took: the port compiles nothing at attribution (a step's CUDA graph
    is captured at its second call), the name is the JAX package's.

At read time (``Engine._refresh_gauges``) the static costs join the
measured ``serving_step_seconds`` means into roofline utilization
against ``costmodel.HardwareConfig``'s card peaks:

  * ``serving_roofline_achieved_flops_per_s{phase=}`` and
    ``serving_roofline_achieved_bytes_per_s{phase=}``,
  * ``serving_roofline_compute_util_ratio{phase=}`` /
    ``serving_roofline_memory_util_ratio{phase=}``.

and into cost-model drift — measurement vs prediction:

  * ``serving_costmodel_wire_drift_ratio`` — measured wire bytes/token
    over the Eq. 1 prediction at the measured per-layer sparsity,
  * ``serving_costmodel_latency_drift_ratio{phase=}`` — measured step
    seconds over ``costmodel.phase_cost`` predicted seconds of the
    paper's accelerator (the absolute value compares two machines; the
    trajectory is the signal, so drift instants fire on change vs the
    first observation),
  * ``serving_costmodel_drift_events_total{phase=}`` — edge-triggered
    out-of-band events, each also dropped as a ``costmodel_drift``
    instant on the tracer's engine track.

Everything here is host-side: the counts read shapes, and no tensor
operation runs in this module.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

DEFAULT_LATENCY_DRIFT_FACTOR = 2.0
DEFAULT_WIRE_DRIFT_TOL = 0.15

# attribution times land in seconds-scale buckets
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                    30.0, 60.0, 120.0)


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Static cost of ONE engine step of a phase (per device shard)."""

    phase: str
    flops: float                 # dot FLOPs per engine step
    hbm_bytes: float             # kernel inputs read + outputs written once
    coll_bytes: Dict[str, float]  # per collective kind (+"total")
    tokens_per_step: int         # tokens one engine step moves
    calls_per_step: int = 1      # step calls per timed phase (draft: γ)
    compile_seconds: float = 0.0

    @property
    def flops_per_token(self) -> float:
        return self.flops / max(self.tokens_per_step, 1)

    @property
    def hbm_bytes_per_token(self) -> float:
        return self.hbm_bytes / max(self.tokens_per_step, 1)


class _PhaseState:
    __slots__ = ("cost", "predict_seconds", "ref_latency_ratio",
                 "out_of_band")

    def __init__(self, cost: StepCost,
                 predict_seconds: Optional[Callable[[float], float]]):
        self.cost = cost
        self.predict_seconds = predict_seconds
        self.ref_latency_ratio: Optional[float] = None
        self.out_of_band = False


class StepAttribution:
    """Owns the attribution metrics and the static per-phase costs.

    One instance per engine (created lazily by ``attribute_steps``); the
    registry's create-or-get makes re-registration across engines
    sharing an ``Observability`` safe.
    """

    def __init__(self, obs, hw=None,
                 latency_drift_factor: float = DEFAULT_LATENCY_DRIFT_FACTOR,
                 wire_drift_tol: float = DEFAULT_WIRE_DRIFT_TOL):
        from repro_torch.core.costmodel import HardwareConfig
        self.obs = obs
        self.hw = hw or HardwareConfig()
        self.latency_drift_factor = float(latency_drift_factor)
        self.wire_drift_tol = float(wire_drift_tol)
        self._phases: Dict[str, _PhaseState] = {}
        self._wire_out_of_band = False
        r = obs.registry
        self._g_flops = r.gauge(
            "serving_step_attr_flops", "dot FLOPs one engine step of "
            "this phase executes (counted from its shapes, per rank)",
            unit="flops", labelnames=("phase",))
        self._g_hbm = r.gauge(
            "serving_step_attr_hbm_bytes", "HBM bytes one engine step "
            "must move: each kernel's inputs read once and outputs "
            "written once (a traffic floor, per rank)", unit="bytes",
            labelnames=("phase",))
        self._g_coll = r.gauge(
            "serving_step_attr_coll_bytes", "collective payload bytes "
            "per engine step, by kind", unit="bytes",
            labelnames=("phase", "kind"))
        self._g_tokens = r.gauge(
            "serving_step_attr_tokens", "tokens one engine step of this "
            "phase moves", unit="tokens", labelnames=("phase",))
        self._h_compile = r.histogram(
            "serving_attr_compile_seconds", "time to count one phase's "
            "step cost from its shapes (nothing is compiled at "
            "attribution)", unit="seconds",
            labelnames=("phase",), buckets=_COMPILE_BUCKETS)
        self._g_flops_s = r.gauge(
            "serving_roofline_achieved_flops_per_s", "attributed FLOPs "
            "over measured mean step wall time", unit="per_second",
            labelnames=("phase",))
        self._g_bytes_s = r.gauge(
            "serving_roofline_achieved_bytes_per_s", "attributed HBM "
            "bytes over measured mean step wall time", unit="per_second",
            labelnames=("phase",))
        self._g_cutil = r.gauge(
            "serving_roofline_compute_util_ratio", "achieved FLOP/s over "
            "HardwareConfig.peak_flops", unit="ratio",
            labelnames=("phase",))
        self._g_mutil = r.gauge(
            "serving_roofline_memory_util_ratio", "achieved HBM bytes/s "
            "over HardwareConfig.hbm_bw", unit="ratio",
            labelnames=("phase",))
        self._g_lat_drift = r.gauge(
            "serving_costmodel_latency_drift_ratio", "measured step "
            "seconds / costmodel.phase_cost predicted seconds",
            unit="ratio", labelnames=("phase",))
        self._g_wire_drift = r.gauge(
            "serving_costmodel_wire_drift_ratio", "measured wire "
            "bytes/token / Eq.1 prediction at measured sparsity",
            unit="ratio")
        self._c_drift = r.counter(
            "serving_costmodel_drift_events_total", "edge-triggered "
            "out-of-band cost-model drift events (phase label 'wire' "
            "for wire-byte drift)", unit="events", labelnames=("phase",))

    # -- static attribution ------------------------------------------------

    def attribute(self, phase: str, count: Callable[[], object], *,
                  tokens_per_step: int, calls_per_step: int = 1,
                  predict_seconds: Optional[Callable[[float], float]] = None
                  ) -> StepCost:
        """Count one step of ``phase`` and register its cost.

        ``count()`` returns the work of ONE step call (``flops``,
        ``hbm_bytes`` and ``coll_bytes`` by kind, as
        ``launch.step_cost.step_cost`` does); the timed phase runs
        ``calls_per_step`` of them. Idempotent per phase: a second call
        for an already-attributed phase returns the cached cost.
        """
        if phase in self._phases:
            return self._phases[phase].cost
        clock = self.obs.registry.clock
        t0 = clock()
        work = count()
        dt = clock() - t0
        coll = {k: v * calls_per_step for k, v in work.coll_bytes.items()}
        cost = StepCost(
            phase=phase,
            flops=work.flops * calls_per_step,
            hbm_bytes=work.hbm_bytes * calls_per_step,
            coll_bytes=coll,
            tokens_per_step=tokens_per_step,
            calls_per_step=calls_per_step,
            compile_seconds=dt)
        self._h_compile.observe(dt, phase=phase)
        self.register_cost(cost, predict_seconds=predict_seconds)
        return cost

    def register_cost(self, cost: StepCost, *,
                      predict_seconds: Optional[Callable[[float], float]]
                      = None) -> None:
        """Install a static cost (the seam ``attribute`` uses; tests
        inject synthetic costs here to pin the drift math)."""
        self._phases[cost.phase] = _PhaseState(cost, predict_seconds)
        self._publish(cost)

    def recount(self, phase: str, count: Callable[[], object]) -> StepCost:
        """Count an attributed phase again, for a cost that depends on
        what the run holds (a KV2 engine's decode reads each page at its
        tier's width): the work is replaced; the tokens and calls a step,
        the predictor and the drift state are kept."""
        st = self._phases[phase]
        work, c = count(), st.cost
        st.cost = dataclasses.replace(
            c, flops=work.flops * c.calls_per_step,
            hbm_bytes=work.hbm_bytes * c.calls_per_step,
            coll_bytes={k: v * c.calls_per_step
                        for k, v in work.coll_bytes.items()})
        self._publish(st.cost)
        return st.cost

    def _publish(self, cost: StepCost) -> None:
        self._g_flops.set(cost.flops, phase=cost.phase)
        self._g_hbm.set(cost.hbm_bytes, phase=cost.phase)
        self._g_tokens.set(cost.tokens_per_step, phase=cost.phase)
        for kind, b in cost.coll_bytes.items():
            self._g_coll.set(b, phase=cost.phase, kind=kind)

    def phases(self) -> List[str]:
        return list(self._phases)

    def cost(self, phase: str) -> Optional[StepCost]:
        st = self._phases.get(phase)
        return st.cost if st else None

    # -- runtime join ------------------------------------------------------

    def observe_runtime(self, phase: str, mean_step_seconds: float,
                        sparsity: float = 0.0) -> None:
        """Join one phase's measured mean step time with its static cost.

        Sets the roofline gauges and, when the phase has a latency
        predictor, the cost-model latency drift ratio. The first
        observation pins the reference ratio; later observations outside
        ``[ref/factor, ref*factor]`` fire an edge-triggered drift event.
        """
        st = self._phases.get(phase)
        if st is None or mean_step_seconds <= 0.0:
            return
        cost = st.cost
        flops_s = cost.flops / mean_step_seconds
        bytes_s = cost.hbm_bytes / mean_step_seconds
        self._g_flops_s.set(flops_s, phase=phase)
        self._g_bytes_s.set(bytes_s, phase=phase)
        self._g_cutil.set(flops_s / self.hw.peak_flops, phase=phase)
        self._g_mutil.set(bytes_s / self.hw.hbm_bw, phase=phase)
        if st.predict_seconds is None:
            return
        predicted = st.predict_seconds(sparsity)
        if predicted <= 0.0:
            return
        ratio = mean_step_seconds / predicted
        self._g_lat_drift.set(ratio, phase=phase)
        if st.ref_latency_ratio is None:
            st.ref_latency_ratio = ratio
            return
        f = self.latency_drift_factor
        out = not (st.ref_latency_ratio / f <= ratio
                   <= st.ref_latency_ratio * f)
        if out and not st.out_of_band:
            self._c_drift.inc(phase=phase)
            self.obs.tracer.instant(
                "costmodel_drift", kind="latency", phase=phase,
                ratio=ratio, reference=st.ref_latency_ratio)
        st.out_of_band = out

    def observe_wire(self, measured_bytes_per_token: float,
                     predicted_bytes_per_token: float) -> None:
        """Judge measured wire bytes/token against the Eq. 1 prediction.

        The ratio should sit at ~1.0 (the codec's bytes are Eq. 1's up
        to PBM-word and stream-byte rounding); outside ``1 ±
        wire_drift_tol`` an edge-triggered drift event fires with phase
        label ``wire``.
        """
        if predicted_bytes_per_token <= 0.0:
            return
        ratio = measured_bytes_per_token / predicted_bytes_per_token
        self._g_wire_drift.set(ratio)
        out = abs(ratio - 1.0) > self.wire_drift_tol
        if out and not self._wire_out_of_band:
            self._c_drift.inc(phase="wire")
            self.obs.tracer.instant(
                "costmodel_drift", kind="wire", phase="wire",
                ratio=ratio, tolerance=self.wire_drift_tol)
        self._wire_out_of_band = out

    # -- export ------------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """JSON-ready per-phase static costs."""
        out: Dict[str, Dict[str, float]] = {}
        for phase, st in self._phases.items():
            c = st.cost
            out[phase] = {
                "flops": c.flops, "hbm_bytes": c.hbm_bytes,
                "coll_bytes_total": c.coll_bytes.get("total", 0.0),
                "tokens_per_step": float(c.tokens_per_step),
                "calls_per_step": float(c.calls_per_step),
                "flops_per_token": c.flops_per_token,
                "hbm_bytes_per_token": c.hbm_bytes_per_token,
                "compile_seconds": c.compile_seconds,
            }
        return out

"""Declarative serving SLOs: sliding-window percentiles + watchdog
(a copy of ``repro.obs.slo``, pure Python, with the same metric names).

An :class:`SLO` pins a percentile of a serving signal (TTFT, TPOT, or
scheduler queue depth) under a target; the :class:`SLOMonitor` evaluates
every attached SLO online over a bounded sliding window of the most
recent samples and drives the watchdog metrics:

  * ``serving_slo_value{slo=}``            — current windowed percentile,
  * ``serving_slo_target{slo=}``           — the declared target,
  * ``serving_slo_compliant{slo=}``        — 1 while the percentile is
    within target, 0 while violating,
  * ``serving_slo_burn_rate{slo=}``        — error-budget burn: the
    fraction of window samples over target divided by the budget
    ``1 - q/100`` (1.0 = burning exactly the allowed budget),
  * ``serving_slo_violations_total{slo=}`` — edge-triggered count of
    compliant -> violating transitions (a sustained violation counts
    once, not per sample),
  * ``serving_slo_samples_total{slo=}``    — samples folded in.

Each compliant -> violating edge also drops an ``slo_violation`` instant
on the tracer's engine track, so violations line up with the engine-step
spans in Perfetto. Everything is deterministic given the sample stream:
the window percentile is nearest-rank (no interpolation), so tests can
pin exact trigger points with a synthetic clock.

Engine integration: ``Engine(..., slos=[...])`` feeds ``ttft``/``tpot``
observations from ``_emit`` and ``queue_depth`` once per scheduler
iteration; ``launch/serve.py --slo`` parses specs like ``ttft:p95<0.5``
(seconds) / ``queue_depth:p50<4`` (requests) from the command line.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import re
from typing import Dict, Iterable, List, Optional

SIGNALS = ("ttft", "tpot", "queue_depth")
_SIGNAL_UNITS = {"ttft": "seconds", "tpot": "seconds",
                 "queue_depth": "requests"}

_SPEC_RE = re.compile(
    r"^(?P<signal>[a-z_]+):p(?P<q>[0-9]+(?:\.[0-9]+)?)"
    r"<(?P<target>[0-9.eE+\-]+)$")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective: ``percentile(signal, window) <= target``."""

    name: str                    # label value (defaults to the spec text)
    signal: str                  # "ttft" | "tpot" | "queue_depth"
    target: float                # threshold (seconds or requests)
    percentile: float = 95.0     # windowed percentile under the target
    window: int = 64             # sliding-window length (samples)
    min_samples: int = 1         # don't judge before this many samples

    def __post_init__(self):
        if self.signal not in SIGNALS:
            raise ValueError(f"SLO {self.name}: unknown signal "
                             f"{self.signal!r} (expected one of {SIGNALS})")
        if not 0.0 < self.percentile <= 100.0:
            raise ValueError(f"SLO {self.name}: percentile must be in "
                             f"(0, 100], got {self.percentile}")
        if self.window < 1 or self.min_samples < 1:
            raise ValueError(f"SLO {self.name}: window and min_samples "
                             f"must be >= 1")
        if not math.isfinite(self.target):
            raise ValueError(f"SLO {self.name}: non-finite target")

    @property
    def unit(self) -> str:
        return _SIGNAL_UNITS[self.signal]


def parse_slo(spec: str, *, window: int = 64) -> SLO:
    """Parse a CLI spec like ``ttft:p95<0.25`` into an :class:`SLO`.

    Format: ``<signal>:p<percentile><<target>`` with the target in the
    signal's unit (seconds for ttft/tpot, requests for queue_depth).
    """
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r}: expected <signal>:pQQ<target, e.g. "
            f"'ttft:p95<0.25' or 'queue_depth:p50<4'")
    return SLO(name=spec.strip(), signal=m.group("signal"),
               target=float(m.group("target")),
               percentile=float(m.group("q")), window=window)


def parse_slo_list(text: str, *, window: int = 64) -> List[SLO]:
    """Parse a comma-separated list of SLO specs (empty -> [])."""
    return [parse_slo(part, window=window)
            for part in text.split(",") if part.strip()]


class SlidingWindow:
    """Bounded sample window with deterministic nearest-rank percentiles.

    Nearest-rank (sorted[ceil(q/100 * n) - 1]) rather than interpolated:
    the result is always an observed sample, so a test that injects a
    spike knows exactly which value the watchdog judges.
    """

    def __init__(self, maxlen: int):
        self._values: collections.deque = collections.deque(maxlen=maxlen)
        self.total = 0

    def __len__(self) -> int:
        return len(self._values)

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            raise ValueError("SlidingWindow: NaN observation")
        self._values.append(value)
        self.total += 1

    def percentile(self, q: float) -> float:
        if not 0.0 < q <= 100.0:
            raise ValueError(q)
        if not self._values:
            return float("nan")
        vals = sorted(self._values)
        rank = math.ceil(q / 100.0 * len(vals))
        return vals[max(rank, 1) - 1]

    def over_fraction(self, threshold: float) -> float:
        """Fraction of window samples strictly above ``threshold``."""
        if not self._values:
            return 0.0
        n_over = sum(1 for v in self._values if v > threshold)
        return n_over / len(self._values)


class _SLOState:
    __slots__ = ("slo", "window", "violating")

    def __init__(self, slo: SLO):
        self.slo = slo
        self.window = SlidingWindow(slo.window)
        self.violating = False


class SLOMonitor:
    """Evaluates a set of SLOs online against an Observability bundle.

    ``observe(signal, value)`` folds one sample into every SLO watching
    that signal and re-judges it immediately; gauge state is always
    current (no refresh step). Violations are edge-triggered: the
    counter and the tracer instant fire on the compliant -> violating
    transition only, and recovery re-arms them.
    """

    def __init__(self, slos: Iterable[SLO], obs):
        self.obs = obs
        self._states: List[_SLOState] = []
        names = set()
        r = obs.registry
        self._g_value = r.gauge(
            "serving_slo_value", "current windowed percentile of the "
            "SLO's signal", unit="value", labelnames=("slo",))
        self._g_target = r.gauge(
            "serving_slo_target", "declared SLO target", unit="value",
            labelnames=("slo",))
        self._g_compliant = r.gauge(
            "serving_slo_compliant", "1 while the SLO is met, 0 while "
            "violating", unit="ratio", labelnames=("slo",))
        self._g_burn = r.gauge(
            "serving_slo_burn_rate", "fraction of window samples over "
            "target / error budget (1-q/100); >1 burns budget faster "
            "than allowed", unit="ratio", labelnames=("slo",))
        self._c_violations = r.counter(
            "serving_slo_violations_total", "compliant->violating edges "
            "(a sustained violation counts once)", unit="events",
            labelnames=("slo",))
        self._c_samples = r.counter(
            "serving_slo_samples_total", "signal samples folded into "
            "SLO windows", unit="events", labelnames=("slo",))
        for slo in slos:
            if slo.name in names:
                raise ValueError(f"duplicate SLO name {slo.name!r}")
            names.add(slo.name)
            self._states.append(_SLOState(slo))
            self._g_target.set(slo.target, slo=slo.name)
            self._g_compliant.set(1.0, slo=slo.name)

    @property
    def slos(self) -> List[SLO]:
        return [st.slo for st in self._states]

    def observe(self, signal: str, value: float) -> None:
        if math.isnan(value):
            return
        for st in self._states:
            if st.slo.signal != signal:
                continue
            st.window.observe(value)
            self._c_samples.inc(slo=st.slo.name)
            self._judge(st)

    def _judge(self, st: _SLOState) -> None:
        slo = st.slo
        if len(st.window) < slo.min_samples:
            return
        p = st.window.percentile(slo.percentile)
        budget = max(1.0 - slo.percentile / 100.0, 1e-9)
        burn = st.window.over_fraction(slo.target) / budget
        violating = p > slo.target
        self._g_value.set(p, slo=slo.name)
        self._g_burn.set(burn, slo=slo.name)
        self._g_compliant.set(0.0 if violating else 1.0, slo=slo.name)
        if violating and not st.violating:
            self._c_violations.inc(slo=slo.name)
            self.obs.tracer.instant(
                "slo_violation", slo=slo.name, signal=slo.signal,
                value=p, target=slo.target, burn_rate=burn)
        st.violating = violating

    def violations(self) -> Dict[str, int]:
        """{slo name: edge-triggered violation count}."""
        return {st.slo.name:
                int(self._c_violations.value(slo=st.slo.name))
                for st in self._states}

    def report(self) -> List[Dict[str, object]]:
        """JSON-ready per-SLO status (what serve.py prints)."""
        out = []
        for st in self._states:
            slo = st.slo
            n = len(st.window)
            p = (st.window.percentile(slo.percentile) if n
                 else float("nan"))
            out.append({
                "slo": slo.name, "signal": slo.signal, "unit": slo.unit,
                "percentile": slo.percentile, "target": slo.target,
                "value": p, "samples": st.window.total,
                "violating": st.violating,
                "violations": int(
                    self._c_violations.value(slo=slo.name)),
                "burn_rate": (float(self._g_burn.value(slo=slo.name))
                              if n >= slo.min_samples else 0.0),
            })
        return out


def attach_engine_slos(engine, slos: Optional[Iterable[SLO]]
                       ) -> Optional[SLOMonitor]:
    """Build a monitor against an engine's Observability (None -> None)."""
    slos = list(slos or [])
    if not slos:
        return None
    return SLOMonitor(slos, engine.obs)

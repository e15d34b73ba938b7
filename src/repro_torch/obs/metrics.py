"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics`` (pure Python), so that the port emits the
same metric names and snapshot schema without importing the JAX package.

The serving stack's quantitative spine: every engine layer
registers named metrics here instead of growing ad-hoc attributes, and
everything downstream — ``Engine.aggregate_stats()``, ``serve.py
--metrics-out``, ``bench_serving --json`` percentile gating — reads the
same registry. Deliberately dependency-free (no prometheus_client): the
paper repro must run in a hermetic container, and the three metric kinds
we need are small.

Conventions (enforced):

  * names match ``^[a-z][a-z0-9_]*$`` (checked at registration AND by
    ``benchmarks/check_metrics_schema.py`` over emitted artifacts);
  * every metric declares a ``unit`` ("seconds", "tokens", "bytes",
    "pages", "ratio", ...) — carried through snapshots so dashboards
    don't have to guess;
  * labels are declared up front (``labelnames``) and passed as kwargs:
    ``hist.observe(dt, phase="prefill")``.

Time never comes from ``time.monotonic`` directly: the registry owns an
injectable ``clock`` (shared with the engine and tracer) so tests drive
deterministic latency histograms.

    reg = MetricsRegistry()
    ttft = reg.histogram("serving_ttft_seconds", "arrival to first token",
                         unit="seconds")
    ttft.observe(0.12)
    reg.snapshot()                       # JSON-ready dict
    print(reg.render_text())             # Prometheus-style exposition
"""
from __future__ import annotations

import contextlib
import math
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# default latency buckets (seconds): CPU-interpret serving steps land in
# the ms..s range; sub-ms and >30 s tails overflow into the edge buckets
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


def _labels_key(labelnames: Tuple[str, ...], labels: Dict) -> Tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str, unit: str,
                 labelnames: Tuple[str, ...], clock):
        self.name = name
        self.help = help
        self.unit = unit
        self.labelnames = labelnames
        self._clock = clock
        self._series: Dict[Tuple, object] = {}

    def _key(self, labels: Dict) -> Tuple:
        return _labels_key(self.labelnames, labels)

    def series_labels(self) -> List[Dict[str, str]]:
        return [dict(zip(self.labelnames, k)) for k in self._series]


class Counter(_Metric):
    """Monotonic accumulator. ``inc`` rejects negative amounts."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins point-in-time value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), float("nan")))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)      # +1 overflow (+Inf)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram with percentile estimation.

    Buckets are upper bounds (ascending); an implicit +Inf bucket catches
    the overflow. ``percentile`` linearly interpolates inside the bucket
    containing the rank — resolution is the bucket width, which is the
    honest precision of a fixed-bucket histogram (the regression gate
    treats percentiles as timings, tolerance 5x, so this is plenty).
    """

    kind = "histogram"

    def __init__(self, name, help, unit, labelnames, clock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, unit, labelnames, clock)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty ascending sequence, got {buckets}")
        if not all(math.isfinite(b) for b in bs):
            raise ValueError(f"histogram {name}: buckets must be finite "
                             f"(+Inf is implicit), got {buckets}")
        self.buckets = bs

    def _get(self, labels: Dict) -> _HistSeries:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if math.isnan(value):
            raise ValueError(f"histogram {self.name}: NaN observation "
                             f"(guard at the call site)")
        s = self._get(labels)
        i = 0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                break
        else:
            i = len(self.buckets)                # overflow bucket
        s.counts[i] += 1
        s.sum += value
        s.count += 1

    @contextlib.contextmanager
    def time(self, **labels):
        """Observe the wall time of a with-block (registry clock)."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(self._clock() - t0, **labels)

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s.sum if s else 0.0

    def mean(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s.sum / s.count if s and s.count else float("nan")

    def percentile(self, q: float, **labels) -> float:
        """Bucket-interpolated percentile, q in [0, 100].

        Rank q lands in some bucket; the return value interpolates
        linearly between that bucket's bounds. Observations past the last
        finite bound clamp to it (an overflow bucket has no upper edge).
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(q)
        s = self._series.get(self._key(labels))
        if s is None or s.count == 0:
            return float("nan")
        target = max(q / 100.0 * s.count, 1e-12)
        cum = 0.0
        lo = 0.0
        for ub, c in zip(self.buckets, s.counts):
            if c and cum + c >= target:
                return lo + (ub - lo) * (target - cum) / c
            cum += c
            lo = ub
        return self.buckets[-1]                  # overflow: clamp


class MetricsRegistry:
    """Named-metric store: create-or-get, snapshot, text exposition.

    ``clock`` is shared with every ``Histogram.time`` block (injectable
    for deterministic tests). Re-registering an existing name returns the
    existing metric when kind/unit/labels agree and raises otherwise —
    two subsystems silently disagreeing about a metric is a bug.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._metrics: Dict[str, _Metric] = {}

    # -- registration ------------------------------------------------------

    def _register(self, cls, name: str, help: str, unit: str,
                  labelnames: Iterable[str], **kw) -> _Metric:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} must match "
                             f"{METRIC_NAME_RE.pattern}")
        if not unit:
            raise ValueError(f"metric {name}: declare a unit "
                             f"('seconds', 'tokens', 'ratio', ...)")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not METRIC_NAME_RE.match(ln):
                raise ValueError(f"metric {name}: bad label name {ln!r}")
        existing = self._metrics.get(name)
        if existing is not None:
            if (type(existing) is not cls or existing.unit != unit
                    or existing.labelnames != labelnames):
                raise ValueError(
                    f"metric {name} re-registered with a different "
                    f"kind/unit/labels ({existing.kind}/{existing.unit}/"
                    f"{existing.labelnames})")
            return existing
        m = cls(name, help, unit, labelnames, self.clock, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", unit: str = "1",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter, name, help, unit, labelnames)

    def gauge(self, name: str, help: str = "", unit: str = "1",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, unit, labelnames)

    def histogram(self, name: str, help: str = "", unit: str = "1",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, unit, labelnames,
                              buckets=buckets)

    # -- access ------------------------------------------------------------

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Scalar value of a counter/gauge series (nan if absent)."""
        m = self._metrics.get(name)
        if m is None:
            return float("nan")
        if isinstance(m, Histogram):
            raise TypeError(f"{name} is a histogram; use get().percentile")
        return m.value(**labels)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-ready dict of every metric and series.

        Histogram series carry raw bucket counts (per-bucket, aligned to
        ``buckets`` + one overflow slot) plus precomputed p50/p90/p99 —
        the quantities the bench gate and dashboards read most.
        """
        out: Dict[str, Dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry = {"type": m.kind, "unit": m.unit, "help": m.help,
                     "series": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                for labels in m.series_labels():
                    s = m._series[m._key(labels)]
                    entry["series"].append({
                        "labels": labels, "count": s.count, "sum": s.sum,
                        "bucket_counts": list(s.counts),
                        "p50": m.percentile(50, **labels),
                        "p90": m.percentile(90, **labels),
                        "p99": m.percentile(99, **labels)})
            else:
                for labels in m.series_labels():
                    entry["series"].append(
                        {"labels": labels, "value": m.value(**labels)})
            out[name] = entry
        return out

    def render_text(self) -> str:
        """Prometheus-style text exposition (OpenMetrics-ish ``# UNIT``).

        Histogram buckets render cumulatively with ``le`` labels plus the
        standard ``_sum`` / ``_count`` series.
        """
        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in labels.items()]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.append(f"# UNIT {name} {m.unit}")
            if isinstance(m, Histogram):
                for labels in m.series_labels():
                    s = m._series[m._key(labels)]
                    cum = 0
                    for ub, c in zip(m.buckets, s.counts):
                        cum += c
                        le = fmt_labels(labels, 'le="%g"' % ub)
                        lines.append(f"{name}_bucket{le} {cum}")
                    inf_label = fmt_labels(labels, 'le="+Inf"')
                    lines.append(f"{name}_bucket{inf_label} {s.count}")
                    lines.append(f"{name}_sum{fmt_labels(labels)} {s.sum:g}")
                    lines.append(f"{name}_count{fmt_labels(labels)} "
                                 f"{s.count}")
            else:
                for labels in m.series_labels():
                    lines.append(f"{name}{fmt_labels(labels)} "
                                 f"{m.value(**labels):g}")
        return "\n".join(lines) + "\n"

"""Serving observability: metrics registry + span tracer.

The engine owns one :class:`Observability` and hands it to the scheduler
and page pool, which register under the JAX package's metric names, so
its metric catalog (``docs/observability.md``) reads the port's
snapshots unchanged. Beside the registry and tracer:

  * validate    — snapshot, attribution/SLO-family and Chrome-trace
                  validators;
  * attribution — per-step cost counted from the step's shapes, joined
                  with measured step times: roofline utilization against
                  the card's peaks and cost-model drift gauges;
  * slo         — declarative serving SLOs (sliding-window percentiles,
                  burn rate, edge-triggered violation watchdog).
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, METRIC_NAME_RE,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (ENGINE_TRACK, REQUEST_TRACK_BASE,
                                   SpanHandle, Tracer)
from repro_torch.obs.validate import validate_chrome_trace, validate_snapshot


class Observability:
    """One registry + one tracer sharing one (injectable) clock."""

    def __init__(self, clock=time.monotonic, trace_capacity: int = 65536,
                 trace: bool = True):
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock, capacity=trace_capacity,
                             enabled=trace)


# attribution/slo import AFTER Observability: host-only leaf modules
# importing repro_torch.obs.metrics directly, re-exported here without a
# package-init cycle
from repro_torch.obs.attribution import StepAttribution, StepCost  # noqa: E402
from repro_torch.obs.slo import (SLO, SLOMonitor, SlidingWindow,  # noqa: E402
                                 attach_engine_slos, parse_slo,
                                 parse_slo_list)

__all__ = ["Counter", "DEFAULT_LATENCY_BUCKETS", "ENGINE_TRACK", "Gauge",
           "Histogram", "METRIC_NAME_RE", "MetricsRegistry", "Observability",
           "REQUEST_TRACK_BASE", "SLO", "SLOMonitor", "SlidingWindow",
           "SpanHandle", "StepAttribution", "StepCost", "Tracer",
           "attach_engine_slos", "parse_slo", "parse_slo_list",
           "validate_chrome_trace", "validate_snapshot"]

"""Serving observability: metrics registry + span tracer.

The engine owns one :class:`Observability` and hands it to the scheduler
and page pool, which register under the JAX package's metric names, so
its metric catalog (``docs/observability.md``) reads the port's
snapshots unchanged. SLOs and step attribution wait for a later slice.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, METRIC_NAME_RE,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (ENGINE_TRACK, REQUEST_TRACK_BASE,
                                   SpanHandle, Tracer)


class Observability:
    """One registry + one tracer sharing one (injectable) clock."""

    def __init__(self, clock=time.monotonic, trace_capacity: int = 65536,
                 trace: bool = True):
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock, capacity=trace_capacity,
                             enabled=trace)


__all__ = ["Counter", "DEFAULT_LATENCY_BUCKETS", "ENGINE_TRACK", "Gauge",
           "Histogram", "METRIC_NAME_RE", "MetricsRegistry", "Observability",
           "REQUEST_TRACK_BASE", "SpanHandle", "Tracer"]

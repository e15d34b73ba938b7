"""Lightweight step-span tracing with Chrome trace-event JSON export.

Answers the question the metrics registry cannot: *where did this step's
time go?* Every host-side serving phase (schedule / prefill chunk /
decode batch / draft window / verify window) runs inside a
``with tracer.span(...)`` block, and the scheduler emits per-request
lifecycle spans (waiting → prefill → decode, preemption gaps included)
onto a per-request track. Events land in a bounded ring buffer — a
long-running engine never grows without bound; old events fall off.

``export_chrome()`` writes the standard Chrome trace-event JSON
(``{"traceEvents": [...]}``, "X" complete events with microsecond
``ts``/``dur``), loadable in Perfetto / chrome://tracing as-is. Span
begin/ends are recorded host-side only — never inside traced/jitted
code — so tracing changes no compiled program.

``profiler_annotations=True`` additionally wraps each span body in
``torch.profiler.record_function``, so engine spans line up with the
device rows of a ``torch.profiler`` session. A copy of
``repro.obs.trace`` with that one substitution.

    tr = Tracer()
    with tr.span("decode_step", step=i):
        ...
    tr.export_chrome("trace.json")       # open in ui.perfetto.dev
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional

ENGINE_TRACK = 0            # tid 0: engine-step phases
REQUEST_TRACK_BASE = 1      # tid rid + 1: per-request lifecycle spans


@dataclasses.dataclass
class SpanHandle:
    """An open span (returned by :meth:`Tracer.begin`)."""
    name: str
    track: int
    t0_us: float
    args: Dict
    closed: bool = False


class Tracer:
    """Ring-buffered span recorder.

    ``clock`` is injectable (seconds; shared with the engine/registry) so
    tests get deterministic timestamps; exported ``ts`` are microseconds
    relative to tracer construction. ``enabled=False`` turns every
    operation into a cheap no-op.
    """

    def __init__(self, clock=time.monotonic, capacity: int = 65536,
                 enabled: bool = True, profiler_annotations: bool = False,
                 pid: int = 0):
        if capacity < 1:
            raise ValueError(capacity)
        self._clock = clock
        self._t0 = clock()
        self.enabled = enabled
        self.profiler_annotations = profiler_annotations
        self.pid = pid
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._open: List[SpanHandle] = []
        self._track_names: Dict[int, str] = {}
        self.dropped = 0            # events evicted by the ring buffer

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _push(self, event: Dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(event)

    def set_track_name(self, track: int, name: str) -> None:
        """Name a tid (rendered as a thread row in Perfetto)."""
        if self.enabled:
            self._track_names[track] = name

    def begin(self, name: str, track: int = ENGINE_TRACK,
              **args) -> Optional[SpanHandle]:
        """Open a span; close it with :meth:`end`. For spans whose begin
        and end live in different call sites (request lifecycle phases);
        block-scoped work should use :meth:`span`."""
        if not self.enabled:
            return None
        h = SpanHandle(name=name, track=track, t0_us=self._now_us(),
                       args=dict(args))
        self._open.append(h)
        return h

    def end(self, handle: Optional[SpanHandle]) -> None:
        if handle is None or not self.enabled or handle.closed:
            return
        handle.closed = True
        try:
            self._open.remove(handle)
        except ValueError:
            pass
        self._push({"name": handle.name, "ph": "X", "ts": handle.t0_us,
                    "dur": self._now_us() - handle.t0_us,
                    "pid": self.pid, "tid": handle.track,
                    "args": handle.args})

    @contextlib.contextmanager
    def span(self, name: str, track: int = ENGINE_TRACK, **args):
        """Record the with-block as one complete ("X") trace event."""
        if not self.enabled:
            yield
            return
        ann = None
        if self.profiler_annotations:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        h = self.begin(name, track=track, **args)
        try:
            yield
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self.end(h)

    def instant(self, name: str, track: int = ENGINE_TRACK, **args) -> None:
        """Record a zero-duration marker (Chrome "i" instant event)."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i", "ts": self._now_us(),
                    "pid": self.pid, "tid": track, "s": "t",
                    "args": dict(args)})

    # -- export ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def export(self) -> Dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Still-open spans are flushed as complete events with duration up
        to now (they stay open in the tracer — export is read-only).
        """
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
             "args": {"name": "sparqle-serving"}}]
        for track in sorted(self._track_names):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self.pid, "tid": track,
                           "args": {"name": self._track_names[track]}})
        events.extend(self._events)
        now = self._now_us()
        for h in self._open:
            events.append({"name": h.name, "ph": "X", "ts": h.t0_us,
                           "dur": now - h.t0_us, "pid": self.pid,
                           "tid": h.track, "args": dict(h.args)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> Dict:
        """Write :meth:`export` to ``path``; returns the trace dict."""
        trace = self.export()
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
        return trace

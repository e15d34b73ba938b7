"""Schema validators for observability artifacts (a copy of
``repro.obs.validate``): what a valid registry snapshot, a valid
attribution/SLO family and a valid (Perfetto-loadable) Chrome trace look
like. Each validator returns
a list of human-readable problems — empty means valid.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.obs.metrics import METRIC_NAME_RE

_KINDS = ("counter", "gauge", "histogram")
_PHASES = ("B", "E", "X", "i", "I", "M", "C")


def validate_snapshot(snap: Dict) -> List[str]:
    """Problems in a ``MetricsRegistry.snapshot()`` dict."""
    problems: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot must be a dict, got {type(snap).__name__}"]
    for name, entry in snap.items():
        where = f"metric {name!r}"
        if not METRIC_NAME_RE.match(str(name)):
            problems.append(f"{where}: name must match "
                            f"{METRIC_NAME_RE.pattern}")
        if not isinstance(entry, dict):
            problems.append(f"{where}: entry must be a dict")
            continue
        kind = entry.get("type")
        if kind not in _KINDS:
            problems.append(f"{where}: type {kind!r} not in {_KINDS}")
        if not entry.get("unit"):
            problems.append(f"{where}: missing declared unit")
        series = entry.get("series")
        if not isinstance(series, list):
            problems.append(f"{where}: series must be a list")
            continue
        for i, s in enumerate(series):
            sw = f"{where} series[{i}]"
            if not isinstance(s.get("labels"), dict):
                problems.append(f"{sw}: missing labels dict")
                continue
            for ln in s["labels"]:
                if not METRIC_NAME_RE.match(str(ln)):
                    problems.append(f"{sw}: bad label name {ln!r}")
            if kind == "histogram":
                buckets = entry.get("buckets")
                if (not isinstance(buckets, list) or not buckets
                        or buckets != sorted(buckets)):
                    problems.append(f"{where}: histogram needs ascending "
                                    f"buckets")
                    continue
                counts = s.get("bucket_counts")
                if (not isinstance(counts, list)
                        or len(counts) != len(buckets) + 1):
                    problems.append(f"{sw}: bucket_counts must have "
                                    f"len(buckets)+1 entries")
                elif sum(counts) != s.get("count"):
                    problems.append(f"{sw}: bucket_counts sum "
                                    f"{sum(counts)} != count "
                                    f"{s.get('count')}")
                if not isinstance(s.get("sum"), (int, float)):
                    problems.append(f"{sw}: missing sum")
                for p in ("p50", "p90", "p99"):
                    if p not in s:
                        problems.append(f"{sw}: missing {p}")
            else:
                v = s.get("value")
                if not isinstance(v, (int, float)):
                    problems.append(f"{sw}: missing scalar value")
    return problems


def _label_set(snap: Dict, name: str, label: str) -> set:
    entry = snap.get(name) or {}
    return {s.get("labels", {}).get(label)
            for s in entry.get("series", [])}


def _series_values(snap: Dict, name: str):
    entry = snap.get(name) or {}
    for s in entry.get("series", []):
        if "value" in s:
            yield s.get("labels", {}), s["value"]


ATTRIBUTION_METRICS = ("serving_step_attr_flops",
                       "serving_step_attr_hbm_bytes",
                       "serving_step_attr_tokens",
                       "serving_attr_compile_seconds")
SLO_METRICS = ("serving_slo_value", "serving_slo_target",
               "serving_slo_compliant", "serving_slo_burn_rate")


def validate_attribution(snap: Dict, require: bool = False) -> List[str]:
    """Family-level contract for the attribution / roofline / drift /
    SLO metrics inside one registry snapshot.

    Present-family consistency is always checked (same phase set across
    the ``serving_step_attr_*`` gauges, non-negative finite values,
    SLO compliance gauges boolean, targets present for every SLO).
    ``require=True`` additionally fails when the attribution family is
    absent entirely, so that a silently un-attributed engine cannot pass
    the schema check.
    """
    problems: List[str] = []
    if not isinstance(snap, dict):
        return ["snapshot must be a dict"]
    has_attr = "serving_step_attr_flops" in snap
    if require and not has_attr:
        problems.append("attribution family missing: no "
                        "serving_step_attr_flops in snapshot (engine "
                        "never ran attribute_steps?)")
    if has_attr:
        for name in ATTRIBUTION_METRICS:
            if name not in snap:
                problems.append(f"attribution family incomplete: "
                                f"{name} missing")
        phases = _label_set(snap, "serving_step_attr_flops", "phase")
        if not phases:
            problems.append("serving_step_attr_flops has no series")
        for name in ("serving_step_attr_hbm_bytes",
                     "serving_step_attr_tokens"):
            got = _label_set(snap, name, "phase")
            if name in snap and got != phases:
                problems.append(f"{name}: phase set {sorted(map(str, got))} "
                                f"!= attr flops phases "
                                f"{sorted(map(str, phases))}")
        for name in ("serving_step_attr_flops",
                     "serving_step_attr_hbm_bytes",
                     "serving_step_attr_tokens",
                     "serving_step_attr_coll_bytes"):
            for labels, v in _series_values(snap, name):
                if not (isinstance(v, (int, float)) and math.isfinite(v)
                        and v >= 0):
                    problems.append(f"{name}{labels}: bad value {v!r}")
        for name in ("serving_roofline_compute_util_ratio",
                     "serving_roofline_memory_util_ratio"):
            for labels, v in _series_values(snap, name):
                if not (isinstance(v, (int, float)) and math.isfinite(v)
                        and v >= 0):
                    problems.append(f"{name}{labels}: utilization must "
                                    f"be finite and >= 0, got {v!r}")
                if labels.get("phase") not in phases:
                    problems.append(f"{name}{labels}: phase not "
                                    f"attributed")
        for labels, v in _series_values(
                snap, "serving_costmodel_wire_drift_ratio"):
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v > 0):
                problems.append(f"serving_costmodel_wire_drift_ratio"
                                f"{labels}: ratio must be finite and "
                                f"> 0, got {v!r}")
    if "serving_slo_value" in snap:
        for name in ("serving_slo_target", "serving_slo_compliant"):
            if name not in snap:
                problems.append(f"SLO family incomplete: {name} missing")
        slos = _label_set(snap, "serving_slo_value", "slo")
        targets = _label_set(snap, "serving_slo_target", "slo")
        if not slos <= targets:
            problems.append(f"SLOs without a target gauge: "
                            f"{sorted(map(str, slos - targets))}")
        for labels, v in _series_values(snap, "serving_slo_compliant"):
            if v not in (0, 0.0, 1, 1.0):
                problems.append(f"serving_slo_compliant{labels}: must "
                                f"be 0 or 1, got {v!r}")
        for labels, v in _series_values(snap, "serving_slo_burn_rate"):
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v >= 0):
                problems.append(f"serving_slo_burn_rate{labels}: must "
                                f"be finite and >= 0, got {v!r}")
    return problems


def validate_chrome_trace(trace: Dict) -> List[str]:
    """Problems in a Chrome trace-event JSON object.

    Checks the event schema Perfetto/chrome://tracing require: a
    ``traceEvents`` list whose entries carry name/ph/pid/tid, numeric
    finite ``ts`` for timed phases, and a non-negative ``dur`` on every
    complete ("X") event.
    """
    problems: List[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a dict, got {type(trace).__name__}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["trace.traceEvents must be a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: event must be a dict")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing name")
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad phase {ph!r}")
            continue
        for idkey in ("pid", "tid"):
            if not isinstance(ev.get(idkey), int):
                problems.append(f"{where}: {idkey} must be an int")
        if ph != "M":
            ts = ev.get("ts")
            if (not isinstance(ts, (int, float)) or not math.isfinite(ts)
                    or ts < 0):
                problems.append(f"{where}: ts must be a finite "
                                f"non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float))
                    or not math.isfinite(dur) or dur < 0):
                problems.append(f"{where}: X event needs non-negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be a dict")
    return problems

"""Traced-step contract checker (layer 2 of the analyzer; torch twin of
``repro.analysis.jaxprcheck``).

Traces the *real* step closures of ``launch/steps.py`` — the engine's
prefill chunk, decode, LSB4-only draft (``msb_skip``) and verify window,
transformer and MoE — on tiny configs with ``make_fx`` on the CPU, where
every kernel wrapper runs its plain version, single-device and on 1x2
and 2x2 meshes (gloo worlds of two and four CPU processes); on one
device also the KV2 decode, the fixed-batch prefill (into caches made
outside it) and decode, and the KV2 page re-codecs of
``serving/tiering.py``: every step that runs as a CUDA graph. Then it
walks each graph's nodes and asserts the representation contracts:

* **TXP001** — every collective matches the committed allowlist (key
  ``<kind>:<op>:<group>:<dtype>``, e.g.
  ``decode:all_reduce_sum:model:int32``).
* **TXP002** — over the model group a SUM all-reduce runs on int32 only
  (the merged LSB+MSB accumulator, never a float partial) and is paired
  1:1 with the f32 MAX all-reduce of the global per-token scale; the
  transformer decode holds exactly two a layer (wo, w_down).
* **TXP003** — from each int-plane matmul the product stays exact
  integer arithmetic until one conversion to int32 (the accumulator),
  and the accumulator meets no float op before its one conversion to
  float (the rescale). The plain versions multiply integer planes in
  float64 (exact at these magnitudes), so a plane matmul is an ``mm`` or
  ``bmm`` whose operands are integer tensors converted.
* **TXP004** — the draft holds exactly half the full decode's int-plane
  matmuls and none whose *activation* operand (the first) comes from the
  MSB extraction (``>> 4``). Only the activation operand is followed:
  the weight's int4 nibbles are unpacked with the same shifts
  (``kernels/ref.py`` ``unpack_int4_k``).
* **TXP005** — no ``_local_scalar_dense``, no host read or copy to the
  CPU (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to('cpu')``, caught while the step is traced) and no op with a
  data-dependent output shape (``nonzero``, ``masked_select``,
  ``unique``, boolean-mask indexing) in any serving step.

Collectives come from the graph, where ``make_fx`` records the c10d
ops; their reduce op and group are read where the step calls
``torch.distributed`` (the graph holds them as opaque script objects),
the n-th call naming the n-th collective node.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from .findings import Finding

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_ROOT = os.path.dirname(PACKAGE_DIR)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_THIS = os.path.abspath(__file__)

# row-parallel linears a transformer layer: the attention output
# projection and the FFN down projection. MoE adds the routed and
# shared-expert down projections, so the exact count is asserted on the
# transformer decode only.
TRANSFORMER_ROW_SITES = 2

_INT_DTYPES = {torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8}
_MATMULS = {"mm", "bmm", "matmul", "_int_mm"}
# ops that move or retype values without arithmetic: an operand traced
# back through them keeps its source (an integer plane, a right shift)
_LAYOUT = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t",
           "expand", "unsqueeze", "squeeze", "clone", "contiguous", "alias",
           "detach", "slice", "select", "_to_copy", "lift_fresh_copy",
           "constant_pad_nd", "unbind", "split", "getitem", "stack", "cat"}
_SHIFTS = {"__rshift__", "rshift", "bitwise_right_shift"}
# the exact integer arithmetic the plain versions run in float64 between
# a plane matmul and its conversion to the int32 accumulator
_EXACT = {"add", "sub", "view", "_unsafe_view", "reshape", "permute",
          "transpose", "squeeze", "unsqueeze", "clone", "sum"}
_DATA_SHAPE = {"nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
               "unique_consecutive", "argwhere", "nonzero_numpy"}
_HOST_READS = ("item", "tolist", "cpu", "numpy", "__array__")
_COLLECTIVES = ("all_reduce", "all_gather", "broadcast",
                "all_gather_into_tensor", "reduce_scatter_tensor",
                "all_to_all_single")


@dataclasses.dataclass
class Collective:
    op: str            # all_reduce_sum | all_reduce_max | all_gather | ...
    group: str         # model | data | world | other
    dtype: str         # the operand's dtype, e.g. "int32"
    node: int = -1     # index of its c10d node in the graph (-1: none)


@dataclasses.dataclass
class HostRead:
    op: str            # item | tolist | cpu | numpy | to_cpu
    where: str         # repro_torch/<file>.py::<qualname>
    line: int          # of the first such call
    count: int = 1     # calls from there during the trace


@dataclasses.dataclass
class TracedStep:
    name: str          # e.g. "decode/transformer/1x2"
    kind: str          # prefill | decode | draft | verify | kv2_decode
                       # | legacy_decode | legacy_prefill | kv2_demote
                       # | kv2_promote
    family: str        # transformer | moe
    mesh: Optional[Tuple[int, int]]
    n_layers: int
    graph: Any         # torch.fx.Graph (None: a host read ended the trace)
    collectives: List[Collective]
    host_reads: List[HostRead]


# ----------------------------------------------------------- graph walks

def _op(node) -> str:
    """``aten.mm.default`` -> ``mm``; ``operator.getitem`` -> ``getitem``."""
    if node.op != "call_function":
        return node.op
    t = node.target
    if getattr(t, "__name__", "") == "getitem":
        return "getitem"
    parts = str(t).split(".")
    return parts[1] if len(parts) >= 3 else parts[-1]


def _namespace(node) -> str:
    return str(node.target).split(".")[0] if node.op == "call_function" \
        else ""


def _dtype(node) -> Optional[torch.dtype]:
    v = node.meta.get("val") if hasattr(node, "meta") else None
    if isinstance(v, (list, tuple)):
        v = next((x for x in v if isinstance(x, torch.Tensor)), None)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _inputs(node) -> List[Any]:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, (list, tuple)):
            out += [x for x in a if hasattr(x, "op")]
        elif hasattr(a, "op"):
            out.append(a)
    return out


def _calls(graph) -> List[Any]:
    """The graph's op nodes (none for a trace a host read stopped)."""
    if graph is None:
        return []
    return [n for n in graph.nodes if n.op == "call_function"]


def _from(node, pred: Callable, depth: int = 0) -> bool:
    """Whether ``pred`` holds for ``node`` or for a node it was moved or
    retyped from (layout ops and conversions, followed back; a ``where``
    to its kept values, the rows a routed projection's live count keeps:
    ``kernels/ref.py`` ``live_rows``)."""
    if pred(node):
        return True
    if depth > 16 or _op(node) not in _LAYOUT | {"where"}:
        return False
    src = node.args[1 if _op(node) == "where" else 0] if node.args else None
    if isinstance(src, (list, tuple)):
        return any(_from(s, pred, depth + 1) for s in src if hasattr(s, "op"))
    return hasattr(src, "op") and _from(src, pred, depth + 1)


def _is_int(node) -> bool:
    return _dtype(node) in _INT_DTYPES


def is_plane_matmul(node) -> bool:
    """A matmul of two integer tensors (converted for the product)."""
    if _op(node) not in _MATMULS or len(node.args) < 2:
        return False
    return all(hasattr(a, "op") and _from(a, _is_int) for a in node.args[:2])


def msb_fed(node) -> bool:
    """Whether a plane matmul's activation operand comes from the MSB
    extraction (a right shift of the int8 activation)."""
    return _from(node.args[0], lambda n: _op(n) in _SHIFTS)


def count_plane_matmuls(graph) -> Tuple[int, int]:
    """(int-plane matmuls, those fed by the activation's MSB plane)."""
    mms = [n for n in _calls(graph) if is_plane_matmul(n)]
    return len(mms), sum(msb_fed(n) for n in mms)


# --------------------------------------------------------------- tracing

def tiny_configs() -> Dict[str, object]:
    """The reference's tiny configs (``jaxprcheck.tiny_configs``), the MoE
    one cut to one layer: its plain expert-batched matmuls loop over the
    experts, which makes its traces the slowest, and a second MoE layer
    checks nothing the first does not."""
    from repro_torch.configs.base import ModelConfig
    return {
        "transformer": ModelConfig(
            name="lint-tiny", family="transformer", n_layers=2,
            d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
            vocab=128, dtype="float32"),
        "moe": ModelConfig(
            name="lint-tiny-moe", family="moe", n_layers=1, d_model=32,
            n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, moe_d_ff=32,
            n_experts=4, top_k=2, n_shared_experts=1, vocab=128,
            dtype="float32"),
    }


def _group_names(lay) -> Dict[str, str]:
    names = {}
    for label, g in (("data", lay.data_group), ("model", lay.model_group)):
        key = getattr(g, "group_name", None)
        if key is not None:
            names[key] = label
    return names


def _group_label(group, names: Dict[str, str]) -> str:
    if group is None:
        return "world"
    return names.get(getattr(group, "group_name", None), "other")


def _site(frame) -> Optional[Tuple[str, int]]:
    """(``path::qualname``, line) of a frame outside torch and this
    module (None inside them: their own host reads are not the step's);
    paths under the source root relative to it."""
    path = os.path.abspath(frame.f_code.co_filename)
    if path.startswith(_TORCH_DIR + os.sep) or path == _THIS:
        return None
    if path.startswith(SRC_ROOT + os.sep):
        path = os.path.relpath(path, SRC_ROOT).replace(os.sep, "/")
    qual = getattr(frame.f_code, "co_qualname", frame.f_code.co_name)
    return f"{path}::{qual}", frame.f_lineno


def _raise_site(tb) -> Tuple[str, int]:
    """The innermost frame of a traceback outside torch and this module."""
    site = ("?", 0)
    while tb is not None:
        site = _site(tb.tb_frame) or site
        tb = tb.tb_next
    return site


@contextlib.contextmanager
def recording(groups: Dict[str, str]) -> Iterator[Tuple[List[Collective],
                                                         List[HostRead]]]:
    """Record, while inside, each ``torch.distributed`` collective (its
    op, the label ``groups`` gives its group's name, its dtype) and each
    host read of a tensor by code outside torch (``item``, ``tolist``,
    ``cpu``, ``numpy``, ``__array__``, ``to('cpu')``), once a site."""
    colls: List[Collective] = []
    reads: List[HostRead] = []
    saved_dist = {n: getattr(dist, n) for n in _COLLECTIVES}
    saved_tensor = {n: getattr(torch.Tensor, n)
                    for n in _HOST_READS + ("to",)}

    def collective(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            t = next((a[k] for k in ("tensor", "input_tensor", "input")
                      if k in a), None)
            op = name
            if name == "all_reduce":
                red = a.get("op", dist.ReduceOp.SUM)
                op = f"all_reduce_{str(red).split('.')[-1].lower()}"
            colls.append(Collective(
                op, _group_label(a.get("group"), groups),
                str(t.dtype).replace("torch.", "") if t is not None
                else "-"))
            return fn(*args, **kw)
        return call

    def caller() -> Optional[Tuple[str, int]]:
        return _site(sys._getframe(3))

    def note(op: str) -> None:
        at = caller()
        if at is None:
            return
        for r in reads:
            if (r.op, r.where) == (op, at[0]):
                r.count += 1
                return
        reads.append(HostRead(op, *at))

    def host_read(name, fn):
        def call(self, *args, **kw):
            note(name)
            return fn(self, *args, **kw)
        return call

    def to(self, *args, **kw):
        dev = kw.get("device", args[0] if args else None)
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev).type == "cpu":
            note("to_cpu")
        return saved_tensor["to"](self, *args, **kw)

    try:
        for n, fn in saved_dist.items():
            setattr(dist, n, collective(n, fn))
        for n in _HOST_READS:
            setattr(torch.Tensor, n, host_read(n, saved_tensor[n]))
        torch.Tensor.to = to
        yield colls, reads
    finally:
        for n, fn in saved_dist.items():
            setattr(dist, n, fn)
        for n, fn in saved_tensor.items():
            setattr(torch.Tensor, n, fn)


def trace(fn: Callable, args, *, name: str, kind: str, family: str,
          n_layers: int, mesh: Optional[Tuple[int, int]] = None,
          groups: Optional[Dict[str, str]] = None) -> TracedStep:
    """``fn(*args)`` traced with ``make_fx`` (it runs once, on the CPU)
    into a :class:`TracedStep`; every persistent tensor the trace wrote
    is restored."""
    from torch.fx.experimental.proxy_tensor import make_fx
    state = [t for a in args if isinstance(a, dict)
             for t in _tensors(a)]
    saved = [t.clone() for t in state]
    graph = None
    try:
        with recording(groups or {}) as (colls, reads), _one_fake_mode():
            graph = make_fx(fn)(*args).graph
    except RuntimeError as e:
        # make_fx refuses to read a traced value on the host: the trace
        # ends there, and the read is the finding
        if "_local_scalar_dense" not in str(e):
            raise
        where, line = _raise_site(e.__traceback__)
        if not reads or reads[-1].where != where:   # not an .item() seen
            reads.append(HostRead("_local_scalar_dense", where, line))
    finally:
        for t, v in zip(state, saved):
            t.copy_(v)
    nodes = [i for i, n in enumerate(_calls(graph))
             if _namespace(n) in ("c10d", "_c10d_functional")
             and not _op(n).startswith("wait")]
    if nodes and len(nodes) != len(colls):
        raise RuntimeError(
            f"{name}: the graph holds {len(nodes)} collectives, the step "
            f"called torch.distributed {len(colls)} times")
    for c, i in zip(colls, nodes):
        c.node = i
    return TracedStep(name, kind, family, mesh, n_layers, graph, colls,
                      reads)


@contextlib.contextmanager
def _one_fake_mode() -> Iterator[None]:
    """A tracing context holding one fake mode, which ``make_fx``'s real
    mode then reuses for every node's metadata (it otherwise builds a
    fake mode, stack capture included, per node: ~1.5x slower)."""
    try:
        from torch._guards import TracingContext, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode
    except ImportError:
        yield
        return
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        yield


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# the KV2 ladder's page re-codecs (``serving/tiering.py``): steps on the
# pool state alone, no params
RECODECS = ("kv2_demote", "kv2_promote")


def _step_inputs(kind: str, b: int, p: int, c: int, t: int, d: int):
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    if kind == "prefill":
        return z(1, c), z(1), torch.full((1,), c, dtype=torch.int32), \
            z(d, p)
    if kind == "verify":
        return z(b, t), z(b), z(b, p)
    if kind == "kv2_decode":
        return z(b), z(b), z(b, p), z(b, p)
    if kind == "legacy_decode":
        return z(b), z(b)
    if kind == "legacy_prefill":
        return (z(b, c),)
    if kind in RECODECS:                # a used page into a free one
        return torch.tensor(1, dtype=torch.int32), \
            torch.tensor(2, dtype=torch.int32)
    return z(b), z(b), z(b, p)


def trace_steps(mesh=None, families=None) -> List[TracedStep]:
    """Trace every serving step kind of the tiny families (``families``
    of :func:`tiny_configs`, all by default) on one device, or on this
    rank of ``mesh`` (a ("data", "model") DeviceMesh; every rank of the
    world must call this). One device adds the kinds that run unsharded
    only: the KV2 ladder's decode and its two page re-codecs, and the
    fixed-batch (``--legacy``) prefill and decode over contiguous
    caches."""
    from repro_torch.distributed.tp import shard_params
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import build_served_params
    from repro_torch.models.model import init_cache
    from repro_torch.serving import tiering
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state

    B, P, C, T = 2, 4, 8, 3
    pc = PoolConfig(n_pages=8, page_size=4)
    lay, shape, groups, d = None, None, {}, 1
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_layout
        lay = mesh_layout(mesh)
        shape = (lay.data_ways, lay.model_ways)
        groups, d = _group_names(lay), lay.data_ways
    tag = "single" if shape is None else f"{shape[0]}x{shape[1]}"
    out: List[TracedStep] = []
    for family, cfg in tiny_configs().items():
        if families is not None and family not in families:
            continue
        params = build_served_params(cfg, 0, "cpu", tile_k=16)
        if lay is not None:
            params = shard_params(params, lay.coords.model_rank,
                                  lay.model_ways)
        pool = init_pool_state(cfg, pc, "cpu",
                               None if lay is None else lay.coords)
        steps = (("prefill", S.make_engine_prefill_chunk(cfg, mesh=mesh)),
                 ("decode", S.make_engine_decode(cfg, mesh=mesh)),
                 ("draft", S.make_engine_decode(cfg, msb_skip=True,
                                                with_telemetry=False,
                                                mesh=mesh)),
                 ("verify", S.make_engine_verify_window(cfg, mesh=mesh)))
        states = dict.fromkeys(("prefill", "decode", "draft", "verify"), pool)
        if mesh is None:
            steps += (("kv2_decode", S.make_engine_decode(cfg, kv2=True)),
                      ("legacy_decode", S.make_serve_decode(cfg)),
                      ("legacy_prefill", S.make_serve_prefill_into(cfg)),
                      ("kv2_demote", tiering.demote_page),
                      ("kv2_promote", tiering.promote_page))
            states["kv2_decode"] = init_pool_state(
                cfg, dataclasses.replace(pc, kv2_pages=4), "cpu")
            for kind in RECODECS:
                states[kind] = states["kv2_decode"]
            for kind in ("legacy_decode", "legacy_prefill"):
                states[kind] = init_cache(cfg, B, P * pc.page_size, "cpu")
        for kind, fn in steps:
            fixed = (states[kind],) if kind in RECODECS else (params,
                                                              states[kind])
            args = fixed + _step_inputs(kind, B // d, P, C, T, d)
            out.append(trace(fn, args, name=f"{kind}/{family}/{tag}",
                             kind=kind, family=family, n_layers=cfg.n_layers,
                             mesh=shape, groups=groups))
    return out


# ----------------------------------------------------------------- rules

def check_collectives(step: TracedStep, out: List[Finding]) -> None:
    """TXP001: every collective must be explicitly allowlisted."""
    for c in step.collectives:
        out.append(Finding(
            "TXP001", f"{step.kind}:{c.op}:{c.group}:{c.dtype}",
            f"step={step.name} node#{c.node} {c.op}",
            f"collective `{c.op}` over the {c.group} group on {c.dtype} "
            "operands"))


def check_row_reduce(step: TracedStep, out: List[Finding]) -> None:
    """TXP002: one int32 SUM a row-parallel linear over the model group,
    paired with the f32 MAX of the global per-token scale."""
    n_sum = n_max = 0
    for c in step.collectives:
        if c.group != "model" or c.op not in ("all_reduce_sum",
                                              "all_reduce_max"):
            continue
        if c.op == "all_reduce_sum":
            n_sum += 1
            if c.dtype != "int32":
                out.append(Finding(
                    "TXP002", f"{step.kind}:{c.op}:model:{c.dtype}",
                    f"step={step.name} node#{c.node} {c.op}",
                    f"SUM all-reduce over the model group on {c.dtype} "
                    "operands — the row-parallel reduce must run on the "
                    "merged int32 accumulator, not a float partial"))
        else:
            n_max += 1
            if c.dtype != "float32":
                out.append(Finding(
                    "TXP002", f"{step.kind}:{c.op}:model:{c.dtype}",
                    f"step={step.name} node#{c.node} {c.op}",
                    f"MAX all-reduce over the model group on {c.dtype} "
                    "operands — the global per-token scale reduce must be "
                    "f32"))
    if n_sum != n_max:
        out.append(Finding(
            "TXP002", f"{step.kind}:sum-max-pairing", f"step={step.name}",
            f"{n_sum} SUM vs {n_max} MAX all-reduce(s) over the model "
            "group — each row-parallel linear contributes exactly one of "
            "each"))
    want = TRANSFORMER_ROW_SITES * step.n_layers
    if step.mesh is not None and step.mesh[1] > 1 and \
            step.family == "transformer" and step.kind == "decode" and \
            n_sum != want:
        out.append(Finding(
            "TXP002", f"{step.kind}:row-site-count", f"step={step.name}",
            f"expected exactly {want} SUM all-reduces over the model group "
            f"({TRANSFORMER_ROW_SITES} a layer: wo, w_down), found "
            f"{n_sum}"))


def _users(node) -> List[Any]:
    return list(node.users)


def check_acc_dtype(step: TracedStep, out: List[Finding]) -> None:
    """TXP003: a plane matmul's product stays exact integer arithmetic
    up to one conversion to int32, and that accumulator meets no float
    op before its conversion to float (the rescale)."""
    calls = _calls(step.graph)
    index = {n: i for i, n in enumerate(calls)}

    def bad(node, msg, key):
        out.append(Finding("TXP003", f"{step.kind}:{key}",
                           f"step={step.name} node#{index.get(node, -1)} "
                           f"{_op(node)}", msg))

    accs = {}         # the int32 accumulators (ordered, each once)
    for mm in calls:
        if not is_plane_matmul(mm):
            continue
        frontier, seen = [mm], set()
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            for u in _users(n):
                op = _op(u)
                if op == "_to_copy":
                    dt = u.kwargs.get("dtype", _dtype(u))
                    if dt == torch.int32:
                        accs[u] = None
                    elif dt in _INT_DTYPES:
                        bad(u, f"int-plane matmul accumulates in {dt} — "
                               "narrower or other than int32", "narrow-accum")
                    else:
                        bad(u, f"int-plane matmul converted to {dt} "
                               "without an int32 accumulator — the planes "
                               "are accumulated in floating point",
                            "float-accum")
                elif op in _EXACT or (op == "mul" and _integral_scalar(u)):
                    frontier.append(u)
                else:
                    bad(u, f"op `{op}` consumes an int-plane product "
                           "before its int32 conversion", op)
    for acc in accs:
        frontier, seen = [acc], set()
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            for u in _users(n):
                op = _op(u)
                dt = _dtype(u)
                if op == "_to_copy" and dt is not None and \
                        dt.is_floating_point:
                    continue                      # the rescale
                if op == "getitem" or _namespace(u) in (
                        "c10d", "_c10d_functional") or dt in _INT_DTYPES \
                        or dt == torch.bool:
                    frontier.append(u)
                elif dt is not None and dt.is_floating_point:
                    bad(u, f"float op `{op}` consumes the int32 "
                           "accumulator before the rescale", op)


def _integral_scalar(node) -> bool:
    """A ``mul`` by a Python number of integer value (the dual pass's
    x16 of the MSB product)."""
    nums = [a for a in node.args if isinstance(a, (int, float))]
    return len(nums) == 1 and float(nums[0]).is_integer()


def check_msb_skip(full: TracedStep, draft: TracedStep,
                   out: List[Finding]) -> None:
    """TXP004: the draft holds exactly half the int-plane matmuls and
    none fed by the activation's MSB plane."""
    f_total, f_msb = count_plane_matmuls(full.graph)
    d_total, d_msb = count_plane_matmuls(draft.graph)
    if f_msb == 0:
        out.append(Finding(
            "TXP004", f"{full.kind}:msb-detector", f"step={full.name}",
            "detector self-check failed: the full step shows no matmul "
            "fed by the MSB-plane shift — the extraction signature changed "
            "and the elision check is blind"))
    if d_total * 2 != f_total:
        out.append(Finding(
            "TXP004", f"{draft.kind}:matmul-halving", f"step={draft.name}",
            f"msb_skip draft has {d_total} int-plane matmuls vs {f_total} "
            "in the full step — expected exactly half (the MSB pass "
            "elided)"))
    if d_msb != 0:
        out.append(Finding(
            "TXP004", f"{draft.kind}:msb-matmul", f"step={draft.name}",
            f"{d_msb} matmul(s) in the msb_skip draft take the "
            "activation's MSB plane (the >> 4 extraction) — the sparse "
            "plane leaked into the draft datapath"))


def check_host_sync(step: TracedStep, out: List[Finding]) -> None:
    """TXP005: no scalar read, host copy or data-dependent shape."""
    for i, n in enumerate(_calls(step.graph)):
        op = _op(n)
        what = None
        if op in ("_local_scalar_dense", "item"):
            what = "reads a device scalar on the host"
        elif op in _DATA_SHAPE:
            what = "has a data-dependent output shape"
        elif op == "index" and any(
                _dtype(x) == torch.bool for x in _inputs(n)[1:]):
            what = "indexes by a boolean mask (a data-dependent shape)"
        elif op in ("_to_copy", "to", "copy") and \
                str(n.kwargs.get("device", "")) == "cpu" and \
                _dtype(n) is not None:
            what = "copies a tensor to the CPU"
        if what:
            out.append(Finding(
                "TXP005", f"{step.kind}:{op}",
                f"step={step.name} node#{i} {op}",
                f"`{op}` {what} inside a serving step"))
    for r in step.host_reads:
        what = (f"`{r.op}` (a host read of a traced value) ended the trace"
                if r.op == "_local_scalar_dense" else
                f"`.{r.op}()` reads a tensor on the host")
        out.append(Finding(
            "TXP005", f"{step.kind}:{r.op}:{r.where}",
            f"step={step.name} {r.where.split('::')[0]}:{r.line}",
            f"{what} inside a serving step ({r.count} call(s) in "
            f"`{r.where.split('::')[-1]}`)"))


def check(steps: List[TracedStep]) -> List[Finding]:
    out: List[Finding] = []
    for st in steps:
        check_collectives(st, out)
        check_row_reduce(st, out)
        check_acc_dtype(st, out)
        check_host_sync(st, out)
    by_name = {st.name: st for st in steps}
    for st in steps:
        if st.kind == "draft":
            full = by_name.get(st.name.replace("draft/", "decode/", 1))
            if full is not None:
                check_msb_skip(full, st, out)
    return out


MESHES = ((1, 2), (2, 2))


def mesh_rank(rank: int, shapes=MESHES,
              families=None) -> Optional[List[Finding]]:
    """A ``launch.mesh.spawn_world`` rank function: the findings of every
    step (of ``families``, all by default) traced on each mesh of
    ``shapes`` as big as the world (rank 0's; None on the others, which
    trace too, for the collectives)."""
    from repro_torch.launch.mesh import make_mesh
    world = dist.get_world_size()
    out: List[Finding] = []
    for shape in shapes:
        if shape[0] * shape[1] == world:
            out += check(trace_steps(make_mesh(*shape), families))
    return out if rank == 0 else None


def run(with_mesh: bool = True) -> List[Finding]:
    """Trace and check every step single-device and, with ``with_mesh``,
    on each mesh of :data:`MESHES` (one gloo world of CPU processes a
    mesh)."""
    findings = check(trace_steps())
    if with_mesh:
        from repro_torch.launch.mesh import spawn_world
        for world in sorted({d * m for d, m in MESHES}):
            findings += spawn_world(mesh_rank, world)[0]
    return findings

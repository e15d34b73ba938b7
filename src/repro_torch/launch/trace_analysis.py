"""A tally over one traced step (torch twin of ``repro.launch.
hlo_analysis``): FLOPs, a byte proxy, collective bytes and the peak of
live bytes, per rank.

Where the reference walks the optimized HLO of a compiled step, this
module watches the step run: :class:`Tally` is a ``TorchDispatchMode``
that sees every op the step dispatches (on fake tensors in the dry-run,
``launch/dryrun.py``, or on real ones), after autograd and the
composite decompositions, so an ``einsum`` arrives as its ``bmm``. It
records, for the rank that runs it:

  * ``flops``: 2·M·N·K for every dot (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``_int_mm``, ``mv``, ``dot``) by the dtype of its
    operands, HLO's names (``bf16``, ``f32``, ``s8``); the kernels'
    custom ops (``kernels/_build.py`` ``kernel_op``) by the rules of
    ``launch/step_cost.py``: a W4A8 matmul 2·M·K·N a pass (two for the
    dual pass, one for its draft and for the dense entry) in ``s8``, an
    attention 4·hd for every (query head, key) pair of the cache it is
    given, the encoders none;
  * ``hbm_bytes``: the operands and results of every dispatched op that
    is not a view (an in-place op counts): eager PyTorch's traffic, op by
    op. It is NOT the
    reference's proxy, which counts XLA's fused ops (a fusion reads its
    inputs and writes its outputs once), so it is larger for the same
    program wherever XLA fuses;
  * ``coll_bytes`` / ``coll_count`` by kind (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``, ``broadcast``,
    ``total``): the payload a rank receives (the results: an all-reduce's
    tensors, an all-gather's output list);
  * the dots and collectives with the most FLOPs and bytes;
  * under :meth:`Tally.scanning`, a block loop of n alike iterations
    (``models/layers.py`` ``blocks``: flash attention's) runs its first
    two iterations alone and counts the second n - 1 times, as the
    reference's analysis counts a scan's body times its trip count
    (not under autograd, whose saved tensors grow with the iterations);
  * ``peak_b``: the most bytes live at once, arguments included. Every
    storage an op's outputs create is counted live from its creation
    until the last tensor that refers to it dies (weakref finalizers);
    the arguments (:meth:`Tally.arguments`) are live throughout, and
    autograd's saved tensors until it frees them (:meth:`Tally.saving`).
    ``torch.distributed._tools.mem_tracker.MemTracker`` imports here,
    but it tracks modules and optimizers of an ``nn.Module`` program;
    this program is functions over trees, so storages are counted
    directly.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Dict, Iterable, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels._build import OP_NAMESPACE

_HLO_DTYPE = {torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float32: "f32", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int32: "s32", torch.int64: "s64",
              torch.bool: "pred"}

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "_int_mm", "mv", "dot"}
_COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_":
                "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "broadcast_": "broadcast"}
_MATMUL_OPS = {"sparqle_matmul", "sparqle_matmul_packed", "quant_matmul"}
_ATTENTION_OPS = {"kv4_paged_decode_attention", "kv4_paged_verify_attention",
                  "kv_tiered_paged_decode_attention", "kv4_decode_attention",
                  "kv4_decode_attention_partial"}


def _leaves(tree) -> Iterable[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape(t: torch.Tensor) -> str:
    return "[" + ",".join(str(d) for d in t.shape) + "]"


class Tally(TorchDispatchMode):
    """The tally of the ops dispatched while it is active (module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.dot_flops: Dict[str, float] = collections.defaultdict(float)
        self.hbm_bytes = 0.0
        self.coll_bytes: Dict[str, float] = collections.defaultdict(float)
        self.coll_count: Dict[str, int] = collections.defaultdict(int)
        self.dots: Dict[str, float] = collections.defaultdict(float)
        self.colls: Dict[str, float] = collections.defaultdict(float)
        self.kernel_ops: Dict[str, int] = collections.defaultdict(int)
        self.argument_b = 0
        self.live_b = 0
        self.peak_b = 0
        self._storages: Dict[int, List] = {}
        self._mult = [1]

    # -- loop scans ---------------------------------------------------------

    def loop(self, n: int):
        """A block loop of ``n`` alike iterations (``models/layers.py``
        ``blocks``): its first two alone run, and what the second
        dispatches counts ``n - 1`` times (nested loops multiply); the
        peak is what they hold, the second's overlapping the first's as
        every later one's does. The reference's HLO analysis counts a
        scan's body times its trip count. Under autograd every iteration
        runs: each one's saved tensors stay live until the backward
        pass, so the peak needs them all."""
        if torch.is_grad_enabled():
            yield from range(n)
            return
        for i in range(min(n, 2)):
            self._mult.append(self._mult[-1] * (n - 1 if i else 1))
            try:
                yield i
            finally:
                self._mult.pop()

    @staticmethod
    def saving():
        """Autograd's saved tensors held as the Python tensors they are
        (an identity pack hook): a tensor saved for the backward pass is
        then live, to the tally, until autograd frees it, not when the
        forward's last name for it goes."""
        keep = lambda t: t  # noqa: E731
        return torch.autograd.graph.saved_tensors_hooks(keep, keep)

    @contextlib.contextmanager
    def scanning(self) -> Iterator[None]:
        """Install :meth:`loop` as the model's loop scan inside."""
        from repro_torch.models import layers
        token = layers.LOOP_SCAN.set(self.loop)
        try:
            yield
        finally:
            layers.LOOP_SCAN.reset(token)

    # -- liveness -----------------------------------------------------------

    def _key(self, t: torch.Tensor):
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return None

    def _track(self, t: torch.Tensor, argument: bool = False) -> None:
        key = self._key(t)
        if key is None:
            return
        rec = self._storages.get(key)
        if rec is None:
            nb = t.untyped_storage().nbytes()
            rec = self._storages[key] = [nb, 0, argument]
            if argument:
                self.argument_b += nb
            self.live_b += nb
            self.peak_b = max(self.peak_b, self.live_b)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] <= 0:
            del self._storages[key]
            self.live_b -= rec[0]

    def arguments(self, tree) -> int:
        """Count every tensor of ``tree`` (dicts, lists, tuples,
        dataclasses of tensors) live from now on: the step's arguments.
        Returns their bytes (each storage once)."""
        before = self.argument_b
        for t in _leaves(tree):
            self._track(t, argument=True)
        return self.argument_b - before

    # -- the ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        if ns == "prim" or name.startswith("lift_fresh"):
            return out     # a Python constant lifted: a few bytes, untracked
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        outs = list(_leaves(out))
        k = self._mult[-1]
        if not view:
            self.hbm_bytes += k * sum(_nbytes(t) for t in _leaves(args))
            self.hbm_bytes += k * sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        if ns == "aten" and name in _DOTS:
            self._dot(name, args)
        elif ns == OP_NAMESPACE:
            self.kernel_ops[name] += k
            self._kernel(name, args)
        return out

    def _dot(self, name: str, args) -> None:
        a, b = ((args[1], args[2]) if name in ("addmm", "baddbmm")
                else (args[0], args[1]))
        if name in ("mv", "dot"):
            flops = 2.0 * a.numel()
        else:
            flops = 2.0 * a.numel() * b.shape[-1]
        flops *= self._mult[-1]
        dt = _HLO_DTYPE.get(a.dtype, str(a.dtype))
        self.dot_flops[dt] += flops
        self.dots[f"{name} {dt} {_shape(a)}x{_shape(b)}"] += flops

    def _kernel(self, name: str, args) -> None:
        if name in _MATMUL_OPS:
            planes, w = args[0], args[1 if name == "quant_matmul" else 3]
            m = planes.shape[-2]
            k, n = 2 * w.shape[-2], w.shape[-1]
            e = w.shape[0] if w.ndim == 3 else 1
            passes = 1 if (name == "quant_matmul" or args[7]) else 2
            flops = 2.0 * e * m * k * n * passes * self._mult[-1]
            self.dot_flops["s8"] += flops
            self.dots[f"{name} s8 M={m} K={k} N={n} E={e} x{passes}"] += flops
        elif name in _ATTENTION_OPS:
            q, k = args[0], args[1]
            hd = q.shape[-1]
            heads = q[..., 0].numel()        # query heads, all rows
            if name in ("kv4_decode_attention",
                        "kv4_decode_attention_partial"):
                keys = k.shape[1]
            else:                            # the table's width of pages
                keys = args[-2 if name != "kv_tiered_paged_decode_attention"
                            else -3].shape[-1] * k.shape[1]
            flops = 4.0 * heads * keys * hd * self._mult[-1]
            dt = _HLO_DTYPE.get(q.dtype, str(q.dtype))
            self.dot_flops[dt] += flops
            self.dots[f"{name} {dt} q{_shape(q)} keys={keys}"] += flops

    def _collective(self, name: str, args, out) -> None:
        kind = _COLLECTIVES.get(name)
        if kind is None:
            return
        if kind == "all-gather":
            payload = sum(_nbytes(t) for t in _leaves(args[0]))
            ts = list(_leaves(args[1]))
        else:
            ts = list(_leaves(args[0]))
            payload = sum(_nbytes(t) for t in ts)
        group = next((a for a in args
                      if hasattr(a, "size") and not isinstance(
                          a, torch.Tensor) and callable(a.size)), None)
        ways = group.size() if group is not None else 0
        payload *= self._mult[-1]
        self.coll_bytes[kind] += payload
        self.coll_count[kind] += self._mult[-1]
        dt = _HLO_DTYPE.get(ts[0].dtype, "?") if ts else "?"
        self.colls[f"{kind} {dt} {_shape(ts[0]) if ts else ''} over "
                   f"{ways}"] += payload

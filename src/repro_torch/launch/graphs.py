"""Compiled serving steps: the counterpart of the JAX package's ``jax.jit``
of its serving steps (``repro.serving.engine``, ``repro.serving.
spec_decode``, the ``--legacy`` prefill and decode of
``repro.launch.serve`` and the KV2 page re-codecs of
``repro.serving.tiering``).

:class:`CompiledStep` wraps one closure of ``launch/steps.py``. On a CUDA
device it captures each call shape once into a ``torch.cuda.CUDAGraph``
and replays it on every later call of that shape, so the thousands of
small launches a 36-layer step makes from the Python layer loop leave the
host as one graph launch. On the CPU the closure runs as it is.

A step's arguments are of two kinds. A tensor argument is an input: each
call copies it into the graph's static buffer. A dict argument is
persistent state that the step reads or writes in place (the param tree,
the page pool, the contiguous caches): the graph holds its addresses. A
Python scalar would be baked into the graph, so it raises.

Per call shape — the shape, dtype and device of every input, and the
addresses (and the non-tensor fields, such as a projection's mode) of
the persistent state:
  1. the first call runs eagerly. This is the warm-up: it builds the
     kernels, allocates the matmul's arrival counters (which raise inside
     a capture), fills the quantizer's cached constants and sets up
     cuBLAS for the head;
  2. the second copies its inputs into static buffers, captures the step
     on a side stream (a capture executes nothing, so the pool is not
     written twice), then replays it;
  3. every later call copies its inputs in, replays, and returns clones
     of the graph's outputs: a caller may keep what a step returned (the
     fixed-batch loop keeps every token) while the next replay rewrites
     the graph's own. Persistent state comes back as the caller's object.

What a graph freezes, and why that holds. Every kernel argument is
recorded at capture: pointers, sizes, and the TMA descriptors that
``csrc/sparqle_matmul.cu`` encodes on the host. Activations live in the
graph's own memory, and weights, pages and caches are persistent state
that a runner is bound to: a call whose persistent tensors moved raises
instead of replaying stale pointers. The matmul's arrival counters are
one buffer a device that every launch leaves zeroed: graphs replayed in
order on one stream share it safely, but two graphs in flight on two
streams would not. The attention's thread-block cluster launches replay
like any kernel. The graphs of one engine may share a memory pool:
nothing handed out aliases it, every graph keeps its own outputs alive,
and one stream replays one graph at a time.

Launch counts: the capture runs inside ``_build.recording_launches`` and
each replay adds the recorded counts once, so ``launch_counts()`` counts
the kernel launches executed, graphs or not.

:func:`disable_graphs` makes every call eager, as ``jax.disable_jit()``
does. A step built with ``capture=False`` is always eager: a tensor-
parallel step whose collectives run over gloo (host work, which a CUDA
graph cannot hold); the engine names that mode in its stats.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

_EAGER = False


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Run every :class:`CompiledStep` call eagerly inside (the
    counterpart of ``jax.disable_jit()``)."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


class CudaGraph:
    """One capture on the card: :meth:`capture` records ``fn(*args)`` on
    the capture side stream and returns its outputs, which live in the
    graph's memory; :meth:`replay` runs it on the current stream."""

    def __init__(self, mempool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.mempool = mempool

    def capture(self, fn: Callable, args: List[Any]):
        # no garbage collection inside the capture: a collected engine's
        # graphs would be destroyed there, which a capturing stream does
        # not permit and which invalidates this capture; dead ones go now
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.mempool):
                return fn(*args)
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


def _state_leaves(tree) -> Iterator[Any]:
    """Every leaf of a persistent-state argument: its tensors, and the
    plain fields (a projection's mode, wire format, bits) that decide
    what code the step runs."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _state_leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _state_leaves(getattr(tree, f.name))
    else:
        yield tree


class _Capture:
    """One call shape of a step: its static input buffers, its graph, the
    graph's outputs and the kernel launches one replay executes."""

    def __init__(self, graph, fn: Callable, args: Tuple[Any, ...]):
        self.graph = graph
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args]
        with _build.recording_launches() as self.launches:
            self.out = graph.capture(fn, self.static)

    def __call__(self, args: Tuple[Any, ...]):
        for buf, a in zip(self.static, args):
            if isinstance(buf, torch.Tensor):
                buf.copy_(a)
        self.graph.replay()
        _build.add_launches(self.launches)
        return self._hand_out(self.out, args)

    def _hand_out(self, out, args):
        if isinstance(out, torch.Tensor):
            return out.clone()
        for captured, arg in zip(self.static, args):
            if out is captured:
                return arg
        if isinstance(out, dict):
            return {k: self._hand_out(v, args) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(self._hand_out(v, args) for v in out)
        return out


class CompiledStep:
    """A serving step captured once per call shape and replayed (see the
    module docstring). ``mempool`` (``torch.cuda.graph_pool_handle()``)
    is shared by the graphs of one engine. ``graph_type`` makes the
    capture, ``CudaGraph`` by default on a CUDA device; on another
    device the step runs as it is unless one is given (the CPU tests
    give a traced stand-in). ``capture=False`` runs every call eagerly
    (module docstring)."""

    def __init__(self, fn: Callable, device, mempool=None,
                 graph_type: Optional[Callable] = None,
                 capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        if graph_type is None and self.device.type == "cuda":
            graph_type = CudaGraph
        if not capture:
            graph_type = None
        self._graph_type = graph_type
        self._mempool = mempool
        self._state: Optional[Tuple[int, ...]] = None
        self._warm: set = set()
        self._captures: Dict[Tuple, _Capture] = {}

    def __call__(self, *args):
        if self._graph_type is None or _EAGER:
            return self.fn(*args)
        key = self._key(args)
        cap = self._captures.get(key)
        if cap is None:
            if key not in self._warm:
                self._warm.add(key)
                return self.fn(*args)
            cap = _Capture(self._graph_type(self._mempool), self.fn, args)
            self._captures[key] = cap
        return cap(args)

    @property
    def captures(self) -> bool:
        """Whether calls are captured and replayed (else each runs as it
        is)."""
        return self._graph_type is not None and not _EAGER

    @property
    def graphs(self) -> int:
        """Call shapes captured so far."""
        return len(self._captures)

    def _key(self, args) -> Tuple:
        inputs, ptrs, fields = [], [], []
        for a in args:
            if isinstance(a, torch.Tensor):
                inputs.append((tuple(a.shape), a.dtype, a.device))
            elif isinstance(a, dict):
                for leaf in _state_leaves(a):
                    if isinstance(leaf, torch.Tensor):
                        ptrs.append(leaf.data_ptr())
                    else:
                        fields.append(leaf)
            else:
                raise TypeError(
                    f"a compiled step takes tensors (inputs) and dicts "
                    f"(persistent state), got {type(a).__name__}: a Python "
                    f"value would be baked into the graph")
        state = tuple(ptrs)
        if self._state is None:
            self._state = state
        elif state != self._state:
            raise RuntimeError(
                "the step's persistent state (params, pool or caches) moved "
                "since its first call: its graphs hold the old addresses")
        return tuple(inputs), state, tuple(fields)

"""JAX param / pool / train-state trees (as numpy arrays) -> the port's
torch trees, and a port train state back to numpy.

Both packages keep the same nested-dict layout, so conversion is a tree
map. A quantized JAX projection is recognised by its fields (``w.q``,
``w.scale``, ``col_mask``, ``l``, ``h``, ``mode``, ``packed``,
``wire_format``) rather than by its class: the port imports nothing of
the JAX package. Leaves are read with ``numpy.asarray``; bf16 arrays
cross as their bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.qlinear import SparqleLinear
from repro_torch.core.quantize import QuantizedTensor


def to_tensor(x, device="cpu") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _is_sparqle_linear(x) -> bool:
    return all(hasattr(x, a) for a in ("w", "col_mask", "l", "h", "mode",
                                       "packed", "wire_format"))


def convert_tree(tree: Any, device="cpu") -> Any:
    """Float or already-quantized JAX param tree, or JAX pool state ->
    torch tree. The clipping constants stay on the CPU (see
    ``core.qlinear``); a packed-wire-format projection stays one, so the
    port serves it through the packed encoder and matmul."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device) for k, v in tree.items()}
    if _is_sparqle_linear(tree):
        w = tree.w
        opt = lambda t, d: None if t is None else to_tensor(t, d)  # noqa: E731
        return SparqleLinear(
            w=QuantizedTensor(to_tensor(w.q, device),
                              to_tensor(w.scale, device),
                              to_tensor(w.zero, device), int(w.bits)),
            col_mask=opt(tree.col_mask, device),
            l=opt(tree.l, "cpu"), h=opt(tree.h, "cpu"),
            mode=tree.mode, packed=bool(tree.packed),
            wire_format=tree.wire_format)
    return to_tensor(tree, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 as ``ml_dtypes.bfloat16`` (the
    JAX side's dtype; ``ml_dtypes`` is imported only for a bf16 leaf)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy_tree(tree: Any) -> Any:
    """torch tree -> numpy tree (for comparisons against JAX output)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return to_numpy(tree)


def convert_train_state(state: Any, device="cpu"):
    """A JAX ``TrainState`` (params and ``OptState`` step/mu/nu; read by
    field name, each leaf through ``numpy.asarray``) -> the port's, on
    ``device``, so both packages can start from the same state."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    opt = state.opt
    return TrainState(convert_tree(state.params, device),
                      OptState(to_tensor(opt.step, device),
                               convert_tree(opt.mu, device),
                               convert_tree(opt.nu, device)))


def train_state_to_numpy(state: Any):
    """The port's ``TrainState`` -> the same NamedTuples with numpy
    leaves (bf16 moments as ``ml_dtypes.bfloat16``): the JAX package
    rebuilds its ``TrainState(params, OptState(step, mu, nu))`` from
    them."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    opt = state.opt
    return TrainState(to_numpy_tree(state.params),
                      OptState(to_numpy(opt.step), to_numpy_tree(opt.mu),
                               to_numpy_tree(opt.nu)))

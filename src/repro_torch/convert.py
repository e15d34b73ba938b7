"""JAX param / pool trees (as numpy arrays) -> the port's torch trees.

Both packages keep the same nested-dict layout, so conversion is a tree
map. A quantized JAX projection is recognised by its fields (``w.q``,
``w.scale``, ``col_mask``, ``l``, ``h``, ``mode``, ``packed``) rather
than by its class: the port imports nothing of the JAX package. Leaves
are read with ``numpy.asarray``; bf16 arrays cross as their bit
patterns.
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
                                       "packed"))


def convert_tree(tree: Any, device="cpu") -> Any:
    """Float or already-quantized JAX param tree, or JAX pool state ->
    torch tree. The clipping constants stay on the CPU (see
    ``core.qlinear``); a packed-wire-format projection converts to the
    unpacked one, which gives bit-identical results."""
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
            mode=tree.mode, packed=bool(tree.packed))
    return to_tensor(tree, device)


def to_numpy_tree(tree: Any) -> Any:
    """torch tree -> numpy tree (for comparisons against JAX output)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()

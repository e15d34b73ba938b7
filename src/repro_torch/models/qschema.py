"""The SPARQLe served tree as a schema (torch twin of
``repro.models.qschema``): no allocation.

:func:`build_quantized_schema` mirrors ``core/qlinear.py``
``quantize_model_params`` leaf for leaf: every quantizable projection
ParamSpec becomes a :class:`SparqleLinear` whose fields are ParamSpecs
of the int4 weight packed two a byte along K (int8), the
per-output-channel scales and zeros, the column-importance mask and the
clipping constants. :func:`tree_abstract` turns it into meta tensors
(the host constants ``l``/``h``, read on the host at every call, stay
real CPU zeros), and :func:`tree_local_shapes` gives the shape of every
leaf as one rank of a mesh holds it: the placement by the logical-axis
rule table (``distributed/sharding.py`` ``spec_for``) that the
reference's ``tree_shardings`` gives as NamedShardings.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.qlinear import SparqleLinear, is_quantizable
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.distributed.sharding import local_dims, spec_for
from repro_torch.models.schema import ParamSpec


def _quantize_spec(spec: ParamSpec, path: str) -> SparqleLinear:
    shape, axes = spec.shape, spec.axes
    stacked = bool(axes) and axes[0] == "layers"
    is_expert = "experts" in axes
    n_prefix = (1 if stacked else 0) + (1 if is_expert else 0)
    if len(shape) != n_prefix + 2:
        raise ValueError(f"{path}: {shape}")
    pre_shape, (k, n) = shape[:n_prefix], shape[n_prefix:]
    pre_axes = axes[:n_prefix]
    k_ax, n_ax = axes[n_prefix], axes[n_prefix + 1]
    packed = k % 2 == 0
    q = ParamSpec(pre_shape + ((k // 2 if packed else k), n), axes,
                  torch.int8, init="zeros")
    scale = ParamSpec(pre_shape + (1, n), pre_axes + (None, n_ax),
                      torch.float32, init="ones")
    zero = ParamSpec(pre_shape + (1, n), pre_axes + (None, n_ax),
                     torch.float32, init="zeros")
    col_mask = ParamSpec(pre_shape + (k,), pre_axes + (k_ax,), torch.bool,
                         init="zeros")
    lh_shape = (shape[0],) if stacked else ()
    lh_axes = ("layers",) if stacked else ()
    l_ = ParamSpec(lh_shape, lh_axes, torch.float32, init="zeros")
    h_ = ParamSpec(lh_shape, lh_axes, torch.float32, init="zeros")
    return SparqleLinear(w=QuantizedTensor(q=q, scale=scale, zero=zero,
                                           bits=4),
                         col_mask=col_mask, l=l_, h=h_, mode="sparqle",
                         packed=packed)


def build_quantized_schema(schema: Dict[str, Any], w_bits: int = 4,
                           mode: str = "sparqle") -> Dict[str, Any]:
    """Schema tree with quantizable leaves replaced by SparqleLinear-of-
    ParamSpec."""

    def walk(tree, prefix=""):
        out = {}
        for key, v in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(v, dict):
                out[key] = walk(v, path)
            elif isinstance(v, ParamSpec) and is_quantizable(
                    path, torch.empty(v.shape, device="meta")):
                sl = _quantize_spec(v, path)
                sl.w.bits = w_bits
                sl.mode = mode
                out[key] = sl
            else:
                out[key] = v
        return out

    return walk(schema)


def map_specs(tree, fn: Callable[[ParamSpec, str], Any], prefix: str = ""):
    """``fn(spec, path)`` at every ParamSpec leaf, through dicts and
    SparqleLinears (whose fields keep their names: ``.../wq/q``,
    ``.../wq/scale``, ``.../wq/zero``, ``.../wq/col_mask``, ``.../wq/l``,
    ``.../wq/h``); the tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: map_specs(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        w = tree.w
        sub = {k: map_specs(getattr(w, k), fn, f"{prefix}/{k}")
               for k in ("q", "scale", "zero")}
        return SparqleLinear(
            w=QuantizedTensor(sub["q"], sub["scale"], sub["zero"], w.bits),
            col_mask=map_specs(tree.col_mask, fn, f"{prefix}/col_mask"),
            l=map_specs(tree.l, fn, f"{prefix}/l"),
            h=map_specs(tree.h, fn, f"{prefix}/h"),
            mode=tree.mode, packed=tree.packed,
            wire_format=tree.wire_format)
    if tree is None:
        return None
    return fn(tree, prefix)


def _host(path: str) -> bool:
    return path.endswith(("/l", "/h"))


def tree_abstract(tree, device="meta", shapes=None,
                  make=torch.empty) -> Any:
    """ParamSpec leaves -> tensors from ``make`` (empty ones) on
    ``device`` (meta: no storage), of the leaf's shape or of its entry
    in ``shapes`` (a tree of shapes of the same structure, e.g.
    :func:`tree_local_shapes`'s); the clipping constants ``l``/``h`` are
    CPU zeros whatever the device."""
    local: Dict[str, tuple] = {}
    if shapes is not None:
        _collect(shapes, local)

    def leaf(s: ParamSpec, path: str):
        shape = local.get(path, s.shape)
        if _host(path):
            return torch.zeros(shape, dtype=s.dtype)
        return make(shape, dtype=s.dtype, device=device)

    return map_specs(tree, leaf)


def _collect(shapes, out: Dict[str, tuple], prefix: str = "") -> None:
    if isinstance(shapes, dict):
        for k, v in shapes.items():
            _collect(v, out, f"{prefix}/{k}" if prefix else k)
    elif isinstance(shapes, SparqleLinear):
        for k, v in (("q", shapes.w.q), ("scale", shapes.w.scale),
                     ("zero", shapes.w.zero), ("col_mask", shapes.col_mask),
                     ("l", shapes.l), ("h", shapes.h)):
            if v is not None:
                out[f"{prefix}/{k}"] = v
    elif shapes is not None:
        out[prefix] = shapes


def tree_specs(tree, mesh_shape: Dict[str, int],
               rules: Optional[Dict] = None) -> Any:
    """ParamSpec leaves -> the entries of their ``spec_for`` placement on
    a mesh of ``mesh_shape`` (the reference's ``tree_shardings``)."""
    return map_specs(tree, lambda s, _: spec_for(s.axes, s.shape,
                                                 mesh_shape, rules))


def tree_local_shapes(tree, mesh_shape: Dict[str, int],
                      rules: Optional[Dict] = None) -> Any:
    """ParamSpec leaves -> the shape one rank holds under its
    ``spec_for`` placement (each dim divided by the ways of the mesh axes
    it is cut over)."""
    return map_specs(tree, lambda s, _: local_dims(
        s.shape, spec_for(s.axes, s.shape, mesh_shape, rules), mesh_shape))


def tree_bytes(tree, shapes=None) -> int:
    """Bytes of every ParamSpec leaf of ``tree`` at its shape, or at its
    entry in ``shapes`` (a tree of the same structure)."""
    local: Dict[str, tuple] = {}
    if shapes is not None:
        _collect(shapes, local)
    total = [0]

    def add(s: ParamSpec, path: str):
        n = 1
        for d in local.get(path, s.shape):
            n *= d
        total[0] += n * torch.empty((), dtype=s.dtype).element_size()

    map_specs(tree, add)
    return total[0]

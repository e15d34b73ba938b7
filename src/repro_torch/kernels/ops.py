"""Public wrappers over the kernels, torch twin of ``repro.kernels.ops``.

:func:`sparqle_linear` is the standalone quantized linear: per-token
scale -> fused encode (quantize, clip, split; in the packed wire format
with ``wire_format='packed'``) -> dual-pass matmul (the LSB4-only draft
with ``msb_skip``) -> rescale. :func:`dense_quant_linear` is the W4A8
baseline: quantize -> single-pass matmul -> rescale.
:func:`sparqle_linear_sharded` is :func:`sparqle_linear` with the
weight partitioned over a mesh axis (tensor parallelism, one process a
rank). All take the JAX
wrappers' ``QuantizedTensor`` payload, (K, N) int4 values in int8, pack
it two per byte along K and run the serving linear
(``core.qlinear.linear``) on it, so they launch the same kernels (the
plain versions on CPU tensors). The kernels take ragged shapes as they
are: the JAX wrappers' tile padding and their ``backend``, ``interpret``
and block-size arguments have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qlinear import (SparqleLinear, linear, msb_skip_scope,
                                      pack_int4)
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.distributed.tp import (TPContext, all_gather, shard_linear,
                                        slice_for_rank, tp_scope)


def _served(w: QuantizedTensor, **fields) -> SparqleLinear:
    return SparqleLinear(
        w=QuantizedTensor(pack_int4(w.q.to(torch.int8)), w.scale, w.zero,
                          w.bits), packed=True, **fields)


def sparqle_linear(
    x: torch.Tensor,
    w: QuantizedTensor,
    *,
    col_mask: Optional[torch.Tensor] = None,
    clip_l=None,
    clip_h=None,
    wire_format: str = "unpacked",
    msb_skip: bool = False,
) -> torch.Tensor:
    """Quantize -> (clip) -> decompose -> dual-pass matmul; x (..., K),
    ``w.q`` (K, N). Both wire formats give the same bits; ``msb_skip``
    gives the LSB4 plane's contribution alone."""
    f32 = lambda v: None if v is None else torch.tensor(  # noqa: E731
        float(v), dtype=torch.float32)
    sl = _served(w, col_mask=col_mask, l=f32(clip_l), h=f32(clip_h),
                 wire_format=wire_format)
    with msb_skip_scope(msb_skip):
        return linear(x, sl)


def sparqle_linear_sharded(
    x: torch.Tensor,
    w: QuantizedTensor,
    *,
    mesh,
    axis: str = "model",
    partition: str = "col",
    col_mask: Optional[torch.Tensor] = None,
    clip_l=None,
    clip_h=None,
    wire_format: str = "unpacked",
    msb_skip: bool = False,
) -> torch.Tensor:
    """:func:`sparqle_linear` on this rank's shard of ``w`` over the mesh
    axis ``axis``; every rank passes the whole x and w and gets the whole
    (replicated) output. ``partition='col'``: the rank's output channels,
    all-gathered in rank order (an exact concatenation). ``'row'``: the
    rank's K slice of x, of the weight and of the mask, through the
    row-parallel linear (one MAX all-reduce of the row amax, the int32
    accumulator, one SUM all-reduce of it, the f32 drain): bit-equal to
    the unsharded call."""
    if partition not in ("col", "row"):
        raise ValueError(f"partition={partition!r}: 'col' or 'row'")
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)
    ways = mesh.size(mesh.mesh_dim_names.index(axis))
    f32 = lambda v: None if v is None else torch.tensor(  # noqa: E731
        float(v), dtype=torch.float32)
    sl = shard_linear(_served(w, col_mask=col_mask, l=f32(clip_l),
                               h=f32(clip_h), wire_format=wire_format),
                       partition, rank, ways)
    with msb_skip_scope(msb_skip):
        if partition == "col":
            return all_gather(linear(x, sl), group, x.ndim - 1)
        with tp_scope(TPContext(ways=ways, group=group)):
            return linear(slice_for_rank(x, -1, rank, ways), sl, tp="row")


def dense_quant_linear(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Baseline dense W4A8 linear (no SPARQLe decomposition)."""
    return linear(x, _served(w, col_mask=None, l=None, h=None, mode="dense"))

"""SPARQLe quantized linear — torch twin of ``repro.core.qlinear``.

``SparqleLinear`` holds a deployed projection: the int4 weight packed two
per byte along K, per-output-channel scales, the offline importance mask
and the clipping constants. :func:`linear` is the single projection entry
point of the model code; on a ``SparqleLinear`` in ``sparqle`` mode it
runs

    per-token scale (plain torch) -> fused encode (quantize, clip, split,
    tile populations) -> dual-pass matmul on the packed weight

through the kernel wrappers, which launch the Hopper kernels for CUDA
tensors and run their plain versions for CPU tensors. The result equals
the JAX package's ``_quantized_apply`` bit for bit: the same int8
planes, the same int32 accumulator, the same ``acc * act_scale *
w_scale`` drain.

The clipping constants ``l``/``h`` stay on the CPU whatever the device of
the weights: they are read on the host at every call (kernel arguments),
and a device scalar would synchronise the stream each time.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from repro_torch.core.clipping import importance_mask_tile_aligned
from repro_torch.core.quantize import (QuantizedTensor, activation_scale,
                                       quantize_weights)
from repro_torch.kernels.sparqle_encode import sparqle_encode
from repro_torch.kernels.sparqle_matmul import sparqle_matmul


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack two's-complement int4 values two per byte along ``axis``:
    byte j holds element 2j in its low and 2j+1 in its high nibble."""
    if q.shape[axis] % 2:
        raise ValueError(f"odd length {q.shape[axis]} on axis {axis}")
    t = q.movedim(axis, -1)
    lo, hi = t[..., 0::2], t[..., 1::2]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.to(torch.int8).movedim(-1, axis).contiguous()


def unpack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extending)."""
    t = q.movedim(axis, -1)
    lo = (t << 4) >> 4
    hi = t >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(*t.shape[:-1],
                                                t.shape[-1] * 2)
    return out.movedim(-1, axis).contiguous()


@dataclasses.dataclass
class SparqleLinear:
    """A quantized projection in SPARQLe served form.

    ``w.q`` is (K/2, N) when ``packed`` (else (K, N): w_bits > 4 or odd
    K, which the matmul kernel does not take), or layer-stacked with a
    leading (L,) axis; ``col_mask`` (K,) bool or None; ``l``/``h`` CPU
    f32 scalars (or (L,) when stacked).
    """

    w: QuantizedTensor
    col_mask: Optional[torch.Tensor]
    l: Optional[torch.Tensor]
    h: Optional[torch.Tensor]
    mode: str = "sparqle"
    packed: bool = False

    def layer(self, i: int) -> "SparqleLinear":
        """The ``i``-th layer of a layer-stacked projection."""
        pick = lambda t: None if t is None else t[i]  # noqa: E731
        return dataclasses.replace(
            self, w=QuantizedTensor(self.w.q[i], self.w.scale[i],
                                    self.w.zero[i], self.w.bits),
            col_mask=pick(self.col_mask), l=pick(self.l), h=pick(self.h))

    def to(self, device) -> "SparqleLinear":
        """Weights and mask to ``device``; ``l``/``h`` stay on the CPU."""
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, w=QuantizedTensor(mv(self.w.q), mv(self.w.scale),
                                    mv(self.w.zero), self.w.bits),
            col_mask=mv(self.col_mask))


def tree_index(tree, i: int):
    """Layer ``i`` of a layer-stacked param subtree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return tree.layer(i)
    return tree[i]


def tree_to(tree, device):
    """Move every tensor / ``SparqleLinear`` of a param tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return tree.to(device)
    return tree.to(device)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Universal projection: x (..., K) @ w (K, N) [+ b]; ``w`` is a float
    tensor or a :class:`SparqleLinear`."""
    if isinstance(w, SparqleLinear):
        y = _quantized_apply(x, w)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _quantized_apply(x: torch.Tensor, sl: SparqleLinear) -> torch.Tensor:
    """per-token scale -> encode (quantize, clip, split) -> dual pass ->
    rescale, through the kernel wrappers."""
    if sl.mode != "sparqle":
        raise NotImplementedError(f"mode={sl.mode!r}: only the sparqle "
                                  f"mode is ported")
    if sl.w.q.ndim != 2:
        raise NotImplementedError("batched (expert) projections")
    if not sl.packed:
        raise NotImplementedError(
            f"unpacked {sl.w.bits}-bit weight: the dual-pass matmul takes "
            f"only int4 weights packed two per byte along K (pack_int4)")
    orig = x.shape
    x2 = x.reshape(-1, orig[-1]).contiguous()
    scale = activation_scale(x2).float()
    clip = sl.col_mask is not None and sl.l is not None
    lsb, msb, _, pop = sparqle_encode(
        x2, scale, sl.col_mask if clip else None,
        int(sl.l) if clip else 0, int(sl.h) if clip else 0, with_pbm=False)
    n = sl.w.q.shape[-1]
    out = sparqle_matmul(lsb, msb, pop, sl.w.q, scale,
                         sl.w.scale.reshape(1, n).float())
    return out.reshape(*orig[:-1], n).to(x.dtype)


# ---------------------------------------------------------------------------
# offline conversion: float param tree -> SPARQLe served tree
# ---------------------------------------------------------------------------

_QUANT_LEAF = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|w_fc|w_proj|w_in|w_out|"
    r"wq_a|wq_b|wkv_a|wkv_b|lm_head|w_shared_gate|w_shared_up|w_shared_down)$")


def is_quantizable(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    return bool(_QUANT_LEAF.search(path.rsplit("/", 1)[-1]))


def quantize_leaf(
    leaf: torch.Tensor,
    *,
    w_bits: int = 4,
    k_percent: float = 50.0,
    clip_l: float = -8.0,
    clip_h: float = 23.0,
    mode: str = "sparqle",
    tile_k: int = 128,
    enable_clipping: bool = True,
) -> SparqleLinear:
    """Quantize one (K, N) projection into served form; the int4 payload
    is packed two per byte along K unless w_bits > 4 or K is odd."""
    if leaf.ndim != 2:
        raise NotImplementedError(f"weight rank {leaf.ndim}: only (K, N) "
                                  f"projections are ported")
    wq = quantize_weights(leaf, bits=w_bits, axis=0)
    mask = (importance_mask_tile_aligned(leaf, k_percent, tile_k)
            if enable_clipping else None)
    do_pack = w_bits <= 4 and wq.q.shape[-2] % 2 == 0
    if do_pack:
        wq = QuantizedTensor(q=pack_int4(wq.q), scale=wq.scale, zero=wq.zero,
                             bits=wq.bits)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return SparqleLinear(
        w=wq, col_mask=mask,
        l=f32(clip_l) if enable_clipping else None,
        h=f32(clip_h) if enable_clipping else None,
        mode=mode, packed=do_pack)


def stack_linears(sls) -> SparqleLinear:
    """Stack per-layer ``SparqleLinear``s along a new leading (L,) axis."""
    st = lambda ts: None if ts[0] is None else torch.stack(ts)  # noqa: E731
    first = sls[0]
    return dataclasses.replace(
        first,
        w=QuantizedTensor(st([s.w.q for s in sls]),
                          st([s.w.scale for s in sls]),
                          st([s.w.zero for s in sls]), first.w.bits),
        col_mask=st([s.col_mask for s in sls]),
        l=st([s.l for s in sls]), h=st([s.h for s in sls]))


def quantize_model_params(
    params: Dict[str, Any],
    *,
    w_bits: int = 4,
    k_percent: float = 50.0,
    clip_l: float = -8.0,
    clip_h: float = 23.0,
    mode: str = "sparqle",
    enable_clipping: bool = True,
    tile_k: int = 128,
) -> Dict[str, Any]:
    """Rewrite every projection leaf of a param tree into SPARQLe form;
    (L, K, N) layer-stacked leaves quantize one layer at a time."""

    def q1(w):
        return quantize_leaf(w, w_bits=w_bits, k_percent=k_percent,
                             clip_l=clip_l, clip_h=clip_h, mode=mode,
                             enable_clipping=enable_clipping, tile_k=tile_k)

    def walk(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif is_quantizable(path, v):
                if v.ndim == 2:
                    out[k] = q1(v)
                elif v.ndim == 3:
                    out[k] = stack_linears([q1(v[i])
                                            for i in range(v.shape[0])])
                else:
                    raise NotImplementedError(f"{path}: rank {v.ndim}")
            else:
                out[k] = v
        return out

    return walk(params)

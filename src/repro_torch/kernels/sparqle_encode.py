"""Fused drain-path SPARQLe encoder: quantize, clip, split, count.

Replaces the Pallas kernel ``repro/kernels/sparqle_encode.py``
``sparqle_encode`` (``_kernel``/``_quantize``) with the CUDA kernel in
``csrc/sparqle_encode.cu``. Bound on the H100 by bytes (one read of x,
three byte planes written); the kernel is one elementwise pass with
one block per population tile, so the tile counts need no second pass.
Unlike the Pallas kernel it also applies the serve-time clip of
``core.clipping.apply_clipping`` between rounding and splitting, and
rounds the quotient to x's dtype first, as ``quantize_activations``
does on the serving path. Ragged M/K edges are masked in the kernel.
The serving linear reads only lsb/msb/pop, so it passes
``with_pbm=False`` and the kernel skips the PBM plane's store (a quarter
of its output bytes).

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_encode_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv,
                                     sparqle_encode_ref)

KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I,
     _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P]))


def sparqle_encode(
    x: torch.Tensor,                # (M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
    *,
    with_pbm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           torch.Tensor]:
    """Returns (lsb4 int8, msb4 int8, pbm bool, tile_pop int32) with
    tile_pop (ceil(M/TILE_M), ceil(K/TILE_K)); pbm is None unless
    ``with_pbm``."""
    if not x.is_cuda:
        lsb, msb, pbm, pop = sparqle_encode_ref(x, scale, col_mask, l, h)
        return lsb, msb, pbm if with_pbm else None, pop
    m, k = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if scale.shape != (m, 1) or scale.dtype != torch.float32 \
            or scale.device != x.device:
        raise ValueError(f"scale must be f32 (M, 1) on {x.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    scale = scale.contiguous()
    mask_ptr = None
    if col_mask is not None:
        if col_mask.shape != (k,) or col_mask.dtype != torch.bool \
                or col_mask.device != x.device:
            raise ValueError("col_mask must be bool (K,) on x's device")
        col_mask = col_mask.contiguous()
        mask_ptr = col_mask.data_ptr()
    lsb = torch.empty((m, k), dtype=torch.int8, device=x.device)
    msb = torch.empty((m, k), dtype=torch.int8, device=x.device)
    pbm = (torch.empty((m, k), dtype=torch.bool, device=x.device)
           if with_pbm else None)
    pop = torch.empty((_cdiv(m, TILE_M), _cdiv(k, TILE_K)),
                      dtype=torch.int32, device=x.device)
    if m and k:
        KERNEL.launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                      scale.data_ptr(), mask_ptr, int(l), int(h),
                      lsb.data_ptr(), msb.data_ptr(),
                      pbm.data_ptr() if with_pbm else None,
                      pop.data_ptr(), m, k)
    return lsb, msb, pbm, pop

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

:func:`sparqle_quantize` is the quantize-only form for the dense W4A8
baseline: the same ``_quantize`` step and serve-time clip, one int8
plane out, no split and no populations (``sparqle_quantize_launch``).
Both kernels share the per-element device function, so its q is the
encoder's 16 * msb4 + lsb4 bit for bit.

:func:`sparqle_encode_packed` replaces the Pallas
``sparqle_encode_packed`` (``_kernel_packed``): the same quantize and
clip emitted in the wire layout of ``core.packing`` (K padded to a
multiple of 32; LSB4/MSB4 two nibbles per byte, the PBM in 32-bit words
carried as int32 bit patterns), plus the tile populations
(``sparqle_encode_packed_launch``).

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_encode_ref`` /
``sparqle_quantize_ref`` / ``sparqle_encode_packed_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.packing import PBM_WORD_BITS, pad_k
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv,
                                     sparqle_encode_packed_ref,
                                     sparqle_encode_ref, sparqle_quantize_ref)

KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I,
     _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P]))
QUANTIZE_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_quantize_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I, _build.P,
     _build.I, _build.I, _build.P], name="sparqle_quantize"))
PACKED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_packed_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I,
     _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.I,
     _build.P], name="sparqle_encode_packed"))


def _check(x, scale, col_mask):
    """Raise unless the operands are what the kernels take; returns the
    contiguous scale and the mask pointer (None without a mask)."""
    m, k = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if scale.shape != (m, 1) or scale.dtype != torch.float32 \
            or scale.device != x.device:
        raise ValueError(f"scale must be f32 (M, 1) on {x.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if col_mask is None:
        return scale.contiguous(), None
    if col_mask.shape != (k,) or col_mask.dtype != torch.bool \
            or col_mask.device != x.device:
        raise ValueError("col_mask must be bool (K,) on x's device")
    return scale.contiguous(), col_mask.contiguous()


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
    scale, col_mask = _check(x, scale, col_mask)
    mask_ptr = None if col_mask is None else col_mask.data_ptr()
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


def sparqle_quantize(
    x: torch.Tensor,                # (M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> torch.Tensor:
    """The clipped int8 activation q (M, K)."""
    if not x.is_cuda:
        return sparqle_quantize_ref(x, scale, col_mask, l, h)
    m, k = x.shape
    scale, col_mask = _check(x, scale, col_mask)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    if m and k:
        QUANTIZE_KERNEL.launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            None if col_mask is None else col_mask.data_ptr(), int(l),
            int(h), q.data_ptr(), m, k)
    return q


def sparqle_encode_packed(
    x: torch.Tensor,                # (M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (lsb4 packed (M, Kp/2) int8, msb4 packed (M, Kp/2) int8,
    PBM words (M, Kp/32) int32, tile_pop (ceil(M/TILE_M),
    ceil(K/TILE_K)) int32) with Kp = ``pad_k(K)``."""
    if not x.is_cuda:
        return sparqle_encode_packed_ref(x, scale, col_mask, l, h)
    m, k = x.shape
    kp = pad_k(k)
    scale, col_mask = _check(x, scale, col_mask)
    lsb = torch.empty((m, kp // 2), dtype=torch.int8, device=x.device)
    msb = torch.empty((m, kp // 2), dtype=torch.int8, device=x.device)
    pbm = torch.empty((m, kp // PBM_WORD_BITS), dtype=torch.int32,
                      device=x.device)
    pop = torch.empty((_cdiv(m, TILE_M), _cdiv(k, TILE_K)),
                      dtype=torch.int32, device=x.device)
    if m and k:
        PACKED_KERNEL.launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            None if col_mask is None else col_mask.data_ptr(), int(l),
            int(h), lsb.data_ptr(), msb.data_ptr(), pbm.data_ptr(),
            pop.data_ptr(), m, k, kp)
    return lsb, msb, pbm, pop

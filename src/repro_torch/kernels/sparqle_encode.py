"""Drain-path SPARQLe encoder: scale, quantize, clip, split, count.

Replaces the Pallas kernels ``repro/kernels/sparqle_encode.py``
``sparqle_encode`` (``_kernel``/``_quantize``) and
``sparqle_encode_packed`` (``_kernel_packed``) with one CUDA body in
``csrc/sparqle_encode.cu``, instantiated for three outputs and for a
scale computed in the kernel or given. Bound on the H100 by bytes (one
read of x, the planes written once). Unlike the Pallas kernel it also
applies the serve-time clip of ``core.clipping.apply_clipping`` between
rounding and splitting, and rounds the quotient to x's dtype first, as
``quantize_activations`` does on the serving path. Ragged M/K edges are
masked in the kernel. The outputs:

* :func:`sparqle_encode`: LSB4/MSB4 byte planes, the PBM plane (the
  serving linear passes ``with_pbm=False`` and the kernel skips its
  store, a quarter of the output bytes) and the tile populations;
* :func:`sparqle_quantize`: the quantize-only form for the dense W4A8
  baseline, one int8 plane, no split and no populations; the same
  per-element function, so its q is the encoder's 16 * msb4 + lsb4 bit
  for bit;
* :func:`sparqle_encode_packed`: the wire layout of ``core.packing`` (K
  padded to a multiple of 32; LSB4/MSB4 two nibbles per byte, the PBM in
  32-bit words carried as int32 bit patterns) and the populations.

The ``*_fused`` entries (:func:`sparqle_encode_fused`,
:func:`sparqle_quantize_fused`, :func:`sparqle_encode_packed_fused`) are
what the serving linear calls: one launch computes the per-token scale
``activation_scale(x).float()`` itself, returns it beside the planes,
and encodes with it, where the linear used to run abs, amax, div,
clamp_min and a cast first. Up to ``MAX_BLOCKS`` blocks share a group
of TILE_M rows (:func:`fused_plan`), each holding its consecutive K
tiles in shared memory; every block reads its rows over all of K for the
amax, forms the scale, then encodes its tiles. The entries that take a
``scale`` run the same body without the amax pass, for a caller with a
scale of its own (an all-reduced amax under tensor parallelism).

Every entry also takes a leading expert axis, x (E, M, K) with an (E,
K) mask (and an (E, M, 1) scale for the entries that take one): one
launch of its batched instance (``*_batched``, grid z = E) encodes every
expert's slab, the outputs carry the E axis, and the
populations are per (expert, TILE_M rows, TILE_K columns), so a tile
never straddles two experts. Their plain versions are the 2-D ones run
expert by expert (``ref.batched``).

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_encode_ref`` /
``sparqle_quantize_ref`` / ``sparqle_encode_packed_ref`` and their
``*_fused_ref`` forms.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.packing import PBM_WORD_BITS, pad_k
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv, plain_for,
                                     sparqle_encode_fused_ref,
                                     sparqle_encode_packed_fused_ref,
                                     sparqle_encode_packed_ref,
                                     sparqle_encode_ref,
                                     sparqle_quantize_fused_ref,
                                     sparqle_quantize_ref)

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

FUSED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_fused_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I,
     _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P],
    name="sparqle_encode_fused"))
QUANTIZE_FUSED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_quantize_fused_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I, _build.P,
     _build.I, _build.I, _build.P], name="sparqle_quantize_fused"))
PACKED_FUSED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_packed_fused_launch",
    [_build.P, _build.I, _build.P, _build.P, _build.I, _build.I,
     _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.I,
     _build.P], name="sparqle_encode_packed_fused"))

# The expert-batched forms of the entries that take a scale: x (E, M, K),
# scale (E, M, 1), an (E, K) mask, one launch (grid z = E); the
# row-parallel routed projection under tensor parallelism calls them.
BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_batched_launch",
    KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_encode_batched"))
QUANTIZE_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_quantize_batched_launch",
    QUANTIZE_KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_quantize_batched"))
PACKED_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_packed_batched_launch",
    PACKED_KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_encode_packed_batched"))

# The fused entries' expert-batched forms: x (E, M, K), an (E, K) mask,
# every output with a leading E axis, one launch (grid z = E).
FUSED_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_fused_batched_launch",
    FUSED_KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_encode_fused_batched"))
QUANTIZE_FUSED_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_quantize_fused_batched_launch",
    QUANTIZE_FUSED_KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_quantize_fused_batched"))
PACKED_FUSED_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_encode.cu", "sparqle_encode_packed_fused_batched_launch",
    PACKED_FUSED_KERNEL.argtypes[:-1] + [_build.I, _build.P],
    name="sparqle_encode_packed_fused_batched"))

# Blocks a row group may have, the most tiles a block of the entries that
# take a scale holds, and the opt-in dynamic shared memory a block may
# use on the H100 (227 KB less room for the kernel's static shared
# memory).
MAX_BLOCKS, SCALE_IN_TILES = 8, 4
MAX_SMEM = 227 * 1024 - 1024


class FusedPlan(NamedTuple):
    """The fused encoder's launch for a width K: ``blocks`` blocks a
    TILE_M-row group, ``tiles`` consecutive TILE_K tiles a block,
    ``smem(x_bf16)`` bytes of dynamic shared memory a block."""
    blocks: int
    tiles: int

    def smem(self, x_bf16: bool) -> int:
        """Population counts, the mask's slice and the x slice, each
        padded to 16 bytes (the kernel's ``fused_smem``)."""
        def align16(n):
            return -(-n // 16) * 16
        return (align16(self.tiles * 4) + align16(self.tiles * TILE_K)
                + TILE_M * self.tiles * TILE_K * (2 if x_bf16 else 4))


def fused_plan(k: int, scale_in: bool = False) -> FusedPlan:
    """The kernel's ``fused_plan``: a pure function of K (and of whether
    the scale is an input, which caps a block at SCALE_IN_TILES)."""
    n_kt = _cdiv(k, TILE_K)
    tiles = _cdiv(n_kt, MAX_BLOCKS)
    if scale_in:
        tiles = min(tiles, SCALE_IN_TILES)
    return FusedPlan(_cdiv(n_kt, tiles), tiles)


def _check_fused(x, col_mask):
    """The unfused checks on x and the mask, and the shared-memory limit
    of the fused launch; returns the contiguous mask (or None). x may
    carry a leading expert axis (E, M, K), the mask then (E, K)."""
    k = x.shape[-1]
    _, col_mask = _check(x, None, col_mask)
    need = fused_plan(k).smem(x.dtype == torch.bfloat16)
    if need > MAX_SMEM:
        raise ValueError(f"K={k} needs {need} B of shared memory a block "
                         f"(limit {MAX_SMEM})")
    return col_mask


def _check(x, scale, col_mask):
    """Raise unless the operands are what the kernels take; returns the
    contiguous scale (None for the fused entries, which form their own)
    and the contiguous mask (None without a mask)."""
    lead, (m, k) = x.shape[:-2], x.shape[-2:]
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be (M, K) or (E, M, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if scale is not None:
        if scale.shape != lead + (m, 1) or scale.dtype != torch.float32 \
                or scale.device != x.device:
            raise ValueError(f"scale must be f32 {lead + (m, 1)} on "
                             f"{x.device}, got {scale.dtype} "
                             f"{tuple(scale.shape)}")
        scale = scale.contiguous()
    if col_mask is None:
        return scale, None
    if col_mask.shape != lead + (k,) or col_mask.dtype != torch.bool \
            or col_mask.device != x.device:
        raise ValueError(f"col_mask must be bool {lead + (k,)} on x's "
                         f"device")
    return scale, col_mask.contiguous()


def _launch(kernel, batched_kernel, x, *args) -> None:
    """One launch of a fused entry on x (M, K), or of its batched form on
    x (E, M, K) with E appended; nothing to launch for an empty x."""
    if x.numel() == 0:
        return
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16))
    if x.ndim == 3:
        batched_kernel.launch(*head, *args, x.shape[0])
    else:
        kernel.launch(*head, *args)


def _entry_op(name: str, kernel, batched_kernel, form: str, fused: bool,
              plain):
    """The custom op of one encoder entry (``_build.kernel_op``): x,
    scale (None for a fused entry), mask, l, h, with_pbm -> its outputs
    in the order the C entry takes their pointers (``form``: 'encode',
    'quantize' or 'packed'), the fused entries' scale last. An encode
    without the PBM returns an empty plane in its place."""

    def outputs(x, with_pbm):
        lead, (m, k) = tuple(x.shape[:-2]), tuple(x.shape[-2:])

        def new(shape, dt):
            return torch.empty(lead + shape, dtype=dt, device=x.device)

        pop = new((_cdiv(m, TILE_M), _cdiv(k, TILE_K)), torch.int32)
        if form == "quantize":
            outs = [new((m, k), torch.int8)]
        elif form == "packed":
            kp = pad_k(k)
            outs = [new((m, kp // 2), torch.int8),
                    new((m, kp // 2), torch.int8),
                    new((m, kp // PBM_WORD_BITS), torch.int32), pop]
        else:
            outs = [new((m, k), torch.int8), new((m, k), torch.int8),
                    new((m, k), torch.bool) if with_pbm else
                    torch.empty(0, dtype=torch.bool, device=x.device), pop]
        if fused:
            outs.append(new((m, 1), torch.float32))
        return outs

    def fake(x: torch.Tensor, scale: Optional[torch.Tensor],
             col_mask: Optional[torch.Tensor], l: int, h: int,
             with_pbm: bool) -> List[torch.Tensor]:
        return outputs(x, with_pbm)

    def cpu(x: torch.Tensor, scale: Optional[torch.Tensor],
            col_mask: Optional[torch.Tensor], l: int, h: int,
            with_pbm: bool) -> List[torch.Tensor]:
        args = (x, col_mask, l, h) if fused else (x, scale, col_mask, l, h)
        outs = plain_for(plain, x.ndim == 3)(*args)
        outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
        if form == "encode" and not with_pbm:
            outs[2] = torch.empty(0, dtype=torch.bool, device=x.device)
        return outs

    @_build.kernel_op(name, fake, cpu)
    def op(x: torch.Tensor, scale: Optional[torch.Tensor],
           col_mask: Optional[torch.Tensor], l: int, h: int,
           with_pbm: bool) -> List[torch.Tensor]:
        outs = outputs(x, with_pbm)
        planes = outs[:-1] if fused else outs
        m, k = x.shape[-2:]
        extra = (m, k, pad_k(k)) if form == "packed" else (m, k)
        _launch(kernel, batched_kernel, x,
                (outs[-1] if fused else scale).data_ptr(),
                None if col_mask is None else col_mask.data_ptr(), l, h,
                *(t.data_ptr() if t.numel() else None for t in planes),
                *extra)
        return outs

    return op


ENCODE_OP = _entry_op("sparqle_encode", KERNEL, BATCHED_KERNEL, "encode",
                      False, sparqle_encode_ref)
QUANTIZE_OP = _entry_op("sparqle_quantize", QUANTIZE_KERNEL,
                        QUANTIZE_BATCHED_KERNEL, "quantize", False,
                        sparqle_quantize_ref)
PACKED_OP = _entry_op("sparqle_encode_packed", PACKED_KERNEL,
                      PACKED_BATCHED_KERNEL, "packed", False,
                      sparqle_encode_packed_ref)
FUSED_OP = _entry_op("sparqle_encode_fused", FUSED_KERNEL,
                     FUSED_BATCHED_KERNEL, "encode", True,
                     sparqle_encode_fused_ref)
QUANTIZE_FUSED_OP = _entry_op("sparqle_quantize_fused",
                              QUANTIZE_FUSED_KERNEL,
                              QUANTIZE_FUSED_BATCHED_KERNEL, "quantize",
                              True, sparqle_quantize_fused_ref)
PACKED_FUSED_OP = _entry_op("sparqle_encode_packed_fused",
                            PACKED_FUSED_KERNEL, PACKED_FUSED_BATCHED_KERNEL,
                            "packed", True, sparqle_encode_packed_fused_ref)


def sparqle_encode(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) or (E, M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
    *,
    with_pbm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           torch.Tensor]:
    """Returns (lsb4 int8, msb4 int8, pbm bool, tile_pop int32) with
    tile_pop (ceil(M/TILE_M), ceil(K/TILE_K)), each with x's leading
    expert axis if it has one; pbm is None unless ``with_pbm``."""
    if not _build.on_card(x):
        lsb, msb, pbm, pop = plain_for(sparqle_encode_ref, x.ndim == 3)(
            x, scale, col_mask, l, h)
        return lsb, msb, pbm if with_pbm else None, pop
    scale, col_mask = _check(x, scale, col_mask)
    lsb, msb, pbm, pop = ENCODE_OP(x, scale, col_mask, int(l), int(h),
                                   with_pbm)
    return lsb, msb, pbm if with_pbm else None, pop


def sparqle_quantize(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) or (E, M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
) -> torch.Tensor:
    """The clipped int8 activation q (M, K) (or (E, M, K))."""
    if not _build.on_card(x):
        return plain_for(sparqle_quantize_ref, x.ndim == 3)(
            x, scale, col_mask, l, h)
    scale, col_mask = _check(x, scale, col_mask)
    return QUANTIZE_OP(x, scale, col_mask, int(l), int(h), False)[0]


def sparqle_encode_packed(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    scale: torch.Tensor,            # (M, 1) or (E, M, 1) f32
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (lsb4 packed (M, Kp/2) int8, msb4 packed (M, Kp/2) int8,
    PBM words (M, Kp/32) int32, tile_pop (ceil(M/TILE_M),
    ceil(K/TILE_K)) int32) with Kp = ``pad_k(K)``, each with x's leading
    expert axis if it has one."""
    if not _build.on_card(x):
        return plain_for(sparqle_encode_packed_ref, x.ndim == 3)(
            x, scale, col_mask, l, h)
    scale, col_mask = _check(x, scale, col_mask)
    return tuple(PACKED_OP(x, scale, col_mask, int(l), int(h), False))


def sparqle_encode_fused(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
    *,
    with_pbm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           torch.Tensor, torch.Tensor]:
    """:func:`sparqle_encode` with the per-token scale computed in the
    same launch: returns (lsb4, msb4, pbm or None, tile_pop, scale (M, 1)
    f32 = ``activation_scale(x).float()``)."""
    if not _build.on_card(x):
        lsb, msb, pbm, pop, scale = plain_for(sparqle_encode_fused_ref,
                                              x.ndim == 3)(x, col_mask, l, h)
        return lsb, msb, pbm if with_pbm else None, pop, scale
    col_mask = _check_fused(x, col_mask)
    lsb, msb, pbm, pop, scale = FUSED_OP(x, None, col_mask, int(l), int(h),
                                         with_pbm)
    return lsb, msb, pbm if with_pbm else None, pop, scale


def sparqle_quantize_fused(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sparqle_quantize` with the scale computed in the same
    launch: returns (q int8 (M, K), scale (M, 1) f32)."""
    if not _build.on_card(x):
        return plain_for(sparqle_quantize_fused_ref, x.ndim == 3)(
            x, col_mask, l, h)
    col_mask = _check_fused(x, col_mask)
    return tuple(QUANTIZE_FUSED_OP(x, None, col_mask, int(l), int(h),
                                   False))


def sparqle_encode_packed_fused(
    x: torch.Tensor,                # (M, K) or (E, M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) or (E, K) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """:func:`sparqle_encode_packed` with the scale computed in the same
    launch: returns (lsb4 packed, msb4 packed, PBM words, tile_pop,
    scale (M, 1) f32)."""
    if not _build.on_card(x):
        return plain_for(sparqle_encode_packed_fused_ref,
                         x.ndim == 3)(x, col_mask, l, h)
    col_mask = _check_fused(x, col_mask)
    return tuple(PACKED_FUSED_OP(x, None, col_mask, int(l), int(h), False))

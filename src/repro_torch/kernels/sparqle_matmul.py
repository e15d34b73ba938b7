"""SPARQLe dual-pass W4A8 matmul with PBM tile skipping.

Replaces the Pallas kernel ``repro/kernels/sparqle_matmul.py``
``sparqle_matmul`` (``_kernel``/``_tile_body``/``_drain``) with the CUDA
kernel in ``csrc/sparqle_matmul.cu``. Bound on the H100 by bytes: the
packed int4 weight stream (K*N/2 bytes) dominates at the serving shapes
(M <= 32 rows). The kernel therefore takes the ``pack_int4`` weight
directly and unpacks in shared memory, keeps the int32 accumulator in
registers across an in-block K loop, skips the MSB pass of every
(TILE_M, TILE_K) tile whose PBM population is 0, and splits K over the
grid when N alone gives too few blocks to fill the card (exact: int32
partial sums meet through atomicAdd). Ragged M/N/K are masked in the
kernel, so no operand is padded.

``msb_skip=True`` is the LSB4-only draft of self-speculative decoding
and replaces the Pallas ``_kernel_draft``: the same CUDA kernel
instantiated without its MSB pass (``sparqle_matmul_draft_launch``),
whose entry takes neither the MSB plane nor the tile populations, so
only the LSB plane and the weight are read.

:func:`sparqle_matmul_packed` replaces the Pallas
``sparqle_matmul_packed`` (``_kernel_packed``, and ``_kernel_packed_draft``
with ``msb_skip``): the activation planes arrive in the wire layout,
(M, pad_k(K)/2) two nibbles per byte, and the kernel instance with
``PACKED`` unpacks them into the tiles the unpacked form fills; the
rest of the kernel is one source, so the two layouts give equal
accumulators.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_matmul_ref`` /
``sparqle_matmul_packed_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import pad_k
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv,
                                     sparqle_matmul_packed_ref,
                                     sparqle_matmul_ref)

KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_launch",
    [_build.P] * 8 + [_build.I] * 4 + [_build.P]))
DRAFT_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_draft_launch",
    [_build.P] * 6 + [_build.I] * 4 + [_build.P],
    name="sparqle_matmul_draft"))
PACKED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_launch",
    [_build.P] * 8 + [_build.I] * 5 + [_build.P],
    name="sparqle_matmul_packed"))
PACKED_DRAFT_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_draft_launch",
    [_build.P] * 6 + [_build.I] * 5 + [_build.P],
    name="sparqle_matmul_packed_draft"))

BN = 64                 # output columns per block (csrc/sparqle_matmul.cu)
TARGET_BLOCKS = 264     # two blocks per SM on the H100's 132 SMs


def _splits(m: int, n: int, k: int) -> int:
    n_kt = _cdiv(k, TILE_K)
    blocks = _cdiv(n, BN) * _cdiv(m, TILE_M)
    want = max(1, min(n_kt, _cdiv(TARGET_BLOCKS, blocks)))
    per = _cdiv(n_kt, want)
    return _cdiv(n_kt, per)


def sparqle_matmul(
    lsb4: torch.Tensor,                 # (M, K) int8 in [0, 15]
    msb4: Optional[torch.Tensor],       # (M, K) int8 in [-8, 7]
    tile_pop: Optional[torch.Tensor],   # (ceil(M/TILE_M), ceil(K/TILE_K)) int32
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    *,
    acc_out: bool = False,
    msb_skip: bool = False,
) -> torch.Tensor:
    """(M, N) f32 ``acc * act_scale * w_scale``, or the int32 ``acc``.
    With ``msb_skip`` acc is the LSB pass alone and ``msb4``/``tile_pop``
    may be None (they are not read)."""
    if not lsb4.is_cuda:
        return sparqle_matmul_ref(lsb4, msb4, tile_pop, w_packed, act_scale,
                                  w_scale, acc_out=acc_out,
                                  msb_skip=msb_skip)
    m, k = lsb4.shape
    k2, n = w_packed.shape
    if k != 2 * k2:
        raise ValueError(f"K mismatch: planes {tuple(lsb4.shape)}, packed "
                         f"weight {tuple(w_packed.shape)}")
    acc, out = _operands(lsb4, msb4, tile_pop, w_packed, act_scale, w_scale,
                         (m, k), acc_out=acc_out, msb_skip=msb_skip)
    out_ptr = None if out is None else out.data_ptr()
    if m and n and k:
        if msb_skip:
            DRAFT_KERNEL.launch(lsb4.data_ptr(), w_packed.data_ptr(),
                                act_scale.data_ptr(), w_scale.data_ptr(),
                                acc.data_ptr(), out_ptr, m, n, k,
                                _splits(m, n, k))
        else:
            KERNEL.launch(lsb4.data_ptr(), msb4.data_ptr(),
                          tile_pop.data_ptr(), w_packed.data_ptr(),
                          act_scale.data_ptr(), w_scale.data_ptr(),
                          acc.data_ptr(), out_ptr, m, n, k, _splits(m, n, k))
    return acc if acc_out else out


def sparqle_matmul_packed(
    lsb4_packed: torch.Tensor,             # (M, pad_k(K)/2) int8
    msb4_packed: Optional[torch.Tensor],   # (M, pad_k(K)/2) int8
    tile_pop: Optional[torch.Tensor],      # (ceil(M/TILE_M), ceil(K/TILE_K))
    w_packed: torch.Tensor,                # (K/2, N) int8, int4 along K
    act_scale: torch.Tensor,               # (M, 1) f32
    w_scale: torch.Tensor,                 # (1, N) f32
    *,
    acc_out: bool = False,
    msb_skip: bool = False,
) -> torch.Tensor:
    """:func:`sparqle_matmul` on wire-layout planes (two nibbles per byte,
    K padded to a multiple of 32; K is the weight's). With ``msb_skip``
    the LSB4-only draft: ``msb4_packed``/``tile_pop`` may be None."""
    if not lsb4_packed.is_cuda:
        return sparqle_matmul_packed_ref(
            lsb4_packed, msb4_packed, tile_pop, w_packed, act_scale,
            w_scale, acc_out=acc_out, msb_skip=msb_skip)
    m = lsb4_packed.shape[0]
    k2, n = w_packed.shape
    k, ldp = 2 * k2, pad_k(2 * k2) // 2
    acc, out = _operands(lsb4_packed, msb4_packed, tile_pop, w_packed,
                         act_scale, w_scale, (m, ldp), acc_out=acc_out,
                         msb_skip=msb_skip)
    out_ptr = None if out is None else out.data_ptr()
    if m and n and k:
        if msb_skip:
            PACKED_DRAFT_KERNEL.launch(
                lsb4_packed.data_ptr(), w_packed.data_ptr(),
                act_scale.data_ptr(), w_scale.data_ptr(), acc.data_ptr(),
                out_ptr, m, n, k, ldp, _splits(m, n, k))
        else:
            PACKED_KERNEL.launch(
                lsb4_packed.data_ptr(), msb4_packed.data_ptr(),
                tile_pop.data_ptr(), w_packed.data_ptr(),
                act_scale.data_ptr(), w_scale.data_ptr(), acc.data_ptr(),
                out_ptr, m, n, k, ldp, _splits(m, n, k))
    return acc if acc_out else out


def _operands(lsb4, msb4, tile_pop, w_packed, act_scale, w_scale,
              plane_shape, *, acc_out: bool, msb_skip: bool):
    """Raise unless the operands are what the kernels take (planes of
    ``plane_shape``); returns the int32 accumulator (zeroed when split)
    and the f32 output (None with ``acc_out``)."""
    m = plane_shape[0]
    k2, n = w_packed.shape
    k = 2 * k2
    dev = lsb4.device
    operands = [("lsb4", lsb4, plane_shape, torch.int8),
                ("w_packed", w_packed, (k2, n), torch.int8),
                ("act_scale", act_scale, (m, 1), torch.float32),
                ("w_scale", w_scale, (1, n), torch.float32)]
    if not msb_skip:
        operands += [("msb4", msb4, plane_shape, torch.int8),
                     ("tile_pop", tile_pop,
                      (_cdiv(m, TILE_M), _cdiv(k, TILE_K)), torch.int32)]
    for name, t, shape, dt in operands:
        if t is None:
            raise ValueError(f"{name} is required unless msb_skip")
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    alloc = torch.zeros if _splits(m, n, k) > 1 else torch.empty
    acc = alloc((m, n), dtype=torch.int32, device=dev)
    out = None if acc_out else torch.empty((m, n), dtype=torch.float32,
                                           device=dev)
    return acc, out

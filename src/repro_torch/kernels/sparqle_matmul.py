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

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_matmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv,
                                     sparqle_matmul_ref)

KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_launch",
    [_build.P] * 8 + [_build.I] * 4 + [_build.P]))

BN = 64                 # output columns per block (csrc/sparqle_matmul.cu)
TARGET_BLOCKS = 264     # two blocks per SM on the H100's 132 SMs


def _splits(m: int, n: int, k: int) -> int:
    n_kt = _cdiv(k, TILE_K)
    blocks = _cdiv(n, BN) * _cdiv(m, TILE_M)
    want = max(1, min(n_kt, _cdiv(TARGET_BLOCKS, blocks)))
    per = _cdiv(n_kt, want)
    return _cdiv(n_kt, per)


def sparqle_matmul(
    lsb4: torch.Tensor,       # (M, K) int8 in [0, 15]
    msb4: torch.Tensor,       # (M, K) int8 in [-8, 7]
    tile_pop: torch.Tensor,   # (ceil(M/TILE_M), ceil(K/TILE_K)) int32
    w_packed: torch.Tensor,   # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,  # (M, 1) f32
    w_scale: torch.Tensor,    # (1, N) f32
    *,
    acc_out: bool = False,
) -> torch.Tensor:
    """(M, N) f32 ``acc * act_scale * w_scale``, or the int32 ``acc``."""
    if not lsb4.is_cuda:
        return sparqle_matmul_ref(lsb4, msb4, tile_pop, w_packed, act_scale,
                                  w_scale, acc_out=acc_out)
    m, k = lsb4.shape
    k2, n = w_packed.shape
    dev = lsb4.device
    if k != 2 * k2:
        raise ValueError(f"K mismatch: planes {tuple(lsb4.shape)}, packed "
                         f"weight {tuple(w_packed.shape)}")
    for name, t, shape, dt in (
            ("msb4", msb4, (m, k), torch.int8),
            ("lsb4", lsb4, (m, k), torch.int8),
            ("tile_pop", tile_pop, (_cdiv(m, TILE_M), _cdiv(k, TILE_K)),
             torch.int32),
            ("w_packed", w_packed, (k2, n), torch.int8),
            ("act_scale", act_scale, (m, 1), torch.float32),
            ("w_scale", w_scale, (1, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    splits = _splits(m, n, k)
    alloc = torch.zeros if splits > 1 else torch.empty
    acc = alloc((m, n), dtype=torch.int32, device=dev)
    out = None if acc_out else torch.empty((m, n), dtype=torch.float32,
                                           device=dev)
    if m and n and k:
        KERNEL.launch(lsb4.data_ptr(), msb4.data_ptr(), tile_pop.data_ptr(),
                      w_packed.data_ptr(), act_scale.data_ptr(),
                      w_scale.data_ptr(), acc.data_ptr(),
                      None if out is None else out.data_ptr(), m, n, k,
                      splits)
    return acc if acc_out else out

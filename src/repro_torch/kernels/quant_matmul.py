"""Dense single-pass W4A8 matmul: the paper's baseline accelerator.

Replaces the Pallas kernel ``repro/kernels/quant_matmul.py``
``quant_matmul`` (``_kernel``) with the CUDA kernel in
``csrc/quant_matmul.cu``: one int8 x int4 pass into an int32
accumulator, drained as ``acc.f32 * act_scale * w_scale`` in the JAX
order. Bound on the H100 by bytes at the serving shapes, like the
dual-pass kernel; its tiling, weight unpack, exact split-K and drain
are in ``csrc/w4a8_tile.cuh``. It takes the ``pack_int4`` weight
the served tree holds (the Pallas kernel takes int8 ``w``), so a dense
and a SPARQLe projection read the same bytes. Since q = 16 * msb4 +
lsb4 exactly, its accumulator equals ``sparqle_matmul``'s on the planes
of the same q, bit for bit.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.quant_matmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import TILE_K, TILE_M, _cdiv, quant_matmul_ref

KERNEL = _build.register(_build.Kernel(
    "quant_matmul.cu", "quant_matmul_launch",
    [_build.P] * 6 + [_build.I] * 4 + [_build.P]))

BN = 64                 # output columns per block (csrc/w4a8_tile.cuh)
TARGET_BLOCKS = 264     # two blocks per SM on the H100's 132 SMs


def _splits(m: int, n: int, k: int) -> int:
    """K splits of the ``w4a8_tile.cuh`` grid (16 rows x BN a block)."""
    n_kt = _cdiv(k, TILE_K)
    blocks = _cdiv(n, BN) * _cdiv(m, TILE_M)
    want = max(1, min(n_kt, _cdiv(TARGET_BLOCKS, blocks)))
    per = _cdiv(n_kt, want)
    return _cdiv(n_kt, per)


def quant_matmul(
    q: torch.Tensor,                    # (M, K) int8
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    *,
    acc_out: bool = False,
) -> torch.Tensor:
    """(M, N) f32 ``acc * act_scale * w_scale``, or the int32 ``acc``."""
    if not q.is_cuda:
        return quant_matmul_ref(q, w_packed, act_scale, w_scale,
                                acc_out=acc_out)
    m, k = q.shape
    k2, n = w_packed.shape
    dev = q.device
    if k != 2 * k2:
        raise ValueError(f"K mismatch: activation {tuple(q.shape)}, packed "
                         f"weight {tuple(w_packed.shape)}")
    for name, t, shape, dt in (
            ("q", q, (m, k), torch.int8),
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
        KERNEL.launch(q.data_ptr(), w_packed.data_ptr(), act_scale.data_ptr(),
                      w_scale.data_ptr(), acc.data_ptr(),
                      None if out is None else out.data_ptr(), m, n, k,
                      splits)
    return acc if acc_out else out

"""Sub-precision sparsity enhancement, serve-time half (paper §3.2).

Torch twin of the deployment functions of ``repro.core.clipping``: the
offline tile-aligned importance mask and the hard integer-domain clip.
Calibration (sweeps, Algorithm 1) waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparqle import LP_HIGH, LP_LOW


def column_importance(w: torch.Tensor) -> torch.Tensor:
    """L1 norm of each weight row. ``w`` is (K, N) for an A(M,K) @ W(K,N)."""
    return w.abs().sum(dim=-1)


def importance_mask_tile_aligned(w: torch.Tensor, k_percent: float,
                                 tile_k: int) -> torch.Tensor:
    """Bool (K,) mask selecting the k% least important ``tile_k``-wide
    column blocks by block-summed importance."""
    imp = column_importance(w)
    k = imp.shape[0]
    pad = (-k) % tile_k
    imp_p = torch.cat([imp, imp.new_full((pad,), float("inf"))])
    blocks = imp_p.reshape(-1, tile_k).sum(dim=1)
    kk = int(blocks.shape[0] * k_percent / 100.0 + 0.5)
    if kk <= 0:
        return torch.zeros((k,), dtype=torch.bool, device=w.device)
    thresh = torch.sort(blocks).values[kk - 1]
    return torch.repeat_interleave(blocks <= thresh, tile_k)[:k]


def apply_clipping(x_int: torch.Tensor, col_mask: torch.Tensor, l, h
                   ) -> torch.Tensor:
    """Hard clip in the integer domain: [l, 0) -> 0, (15, h] -> 15 on the
    masked columns; values outside [l, h] untouched."""
    x = x_int.to(torch.int32)
    l, h = int(l), int(h)
    clip_lo = col_mask & (x >= l) & (x < LP_LOW)
    clip_hi = col_mask & (x > LP_HIGH) & (x <= h)
    y = torch.where(clip_lo, LP_LOW, torch.where(clip_hi, LP_HIGH, x))
    return y.to(x_int.dtype)

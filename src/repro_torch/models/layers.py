"""Shared layers of the paged serving path (torch twin of
``repro.models.layers``): RMSNorm, RoPE, embedding and the inter-layer
activation wire telemetry."""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.packing import dense_bytes_rows, measured_wire_bytes_rows
from repro_torch.core.quantize import quantize_activations
from repro_torch.core.sparqle import subprecision_sparsity

NEG_INF = -2.0e38


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """f32 RMSNorm with a zero-centred gain: ``x * rsqrt(var) * (1 + g)``."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotate the two HALVES of the last dim (not interleaved pairs).
    x (..., S, H, hd) with positions (..., S), or (B, H, hd) with (B,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def act_wire_telemetry(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row int8 MSB4 sparsity, measured packed-wire bytes and dense
    int8 bytes of a hidden activation tensor (..., D)."""
    q = quantize_activations(x, bits=8, per_token=True).q
    return {
        "sparsity": subprecision_sparsity(q, axis=-1),
        "wire_bytes": measured_wire_bytes_rows(q).float(),
        "dense_bytes": torch.full(q.shape[:-1], float(dense_bytes_rows(q)),
                                  dtype=torch.float32, device=q.device),
    }


def stack_sublayer_telemetry(tels: List[Dict[str, torch.Tensor]]
                             ) -> Dict[str, torch.Tensor]:
    """Stack per-sub-layer telemetry dicts into per-key (L, ...) tensors."""
    return {k: torch.stack([t[k] for t in tels], 0) for k in tels[0]}

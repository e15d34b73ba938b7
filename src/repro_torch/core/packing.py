"""Wire-format accounting of the SPARQLe packed layout (serving telemetry).

The subset of ``repro.core.packing`` that the serving path needs: the
measured bytes a row would occupy in the packed wire format (LSB4 pairs
+ PBM words + compacted MSB stream), computed without running the codec.
The codec itself waits for the packed wire format port.
"""
from __future__ import annotations

import torch

PBM_WORD_BITS = 32
K_ALIGN = 32          # lcm(2 nibbles/byte, 32 PBM bits/word)


def pad_k(k: int) -> int:
    """Padded column count of the wire layout for a logical width ``k``."""
    return k + (-k) % K_ALIGN


def measured_wire_bytes_rows(q_int8: torch.Tensor) -> torch.Tensor:
    """Measured packed-wire bytes per row of an int8 tensor (..., K):
    ``Kp/2 + 4*Kp/32 + ceil(popcount/2)`` (int32)."""
    q = q_int8.to(torch.int8)
    kp = pad_k(q.shape[-1])
    nnz = ((q >> 4) != 0).sum(dim=-1, dtype=torch.int32)
    fixed = kp // 2 + (kp // PBM_WORD_BITS) * 4
    return fixed + torch.div(nnz + 1, 2, rounding_mode="floor")


def dense_bytes_rows(q_int8: torch.Tensor) -> int:
    """Dense int8 bytes per row (the baseline the wire format displaces)."""
    return q_int8.shape[-1]

"""Wire-format accounting of the SPARQLe packed layout (serving telemetry)
and the width-k plane codec of the KV2 tier.

The subset of ``repro.core.packing`` that the serving path needs: the
measured bytes a row would occupy in the packed wire format (LSB4 pairs
+ PBM words + compacted MSB stream), computed without running the codec,
and ``pack_plane``/``unpack_plane``, which the KV2 precision ladder
(``serving/tiering.py``) re-codes pages with. The activation codec
itself waits for the packed wire format port.
"""
from __future__ import annotations

import torch

PBM_WORD_BITS = 32
K_ALIGN = 32          # lcm(2 nibbles/byte, 32 PBM bits/word)
PLANE_WIDTHS = (1, 2, 4, 8)   # bit widths the plane codec supports


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


def pack_plane(vals: torch.Tensor, *, width: int = 4) -> torch.Tensor:
    """(..., K mult of 8/width) values -> (..., K*width/8) bytes (int8).

    ``8/width`` fields per byte, little-endian within the byte: field
    ``i`` of byte ``j`` (value ``j*(8/width) + i``) occupies bits
    ``[i*width, (i+1)*width)``. Only the low ``width`` bits of each value
    travel, so signed and unsigned fields pack alike."""
    if width not in PLANE_WIDTHS:
        raise ValueError(f"width must be one of {PLANE_WIDTHS}, got {width}")
    per = 8 // width
    if vals.shape[-1] % per:
        raise ValueError(f"last dim {vals.shape[-1]} is not a multiple of "
                         f"{per} (width {width})")
    mask = (1 << width) - 1
    v = vals.to(torch.int32)
    acc = torch.zeros_like(v[..., 0::per])
    for i in range(per):
        acc |= (v[..., i::per] & mask) << (i * width)
    return acc.to(torch.uint8).view(torch.int8)


def unpack_plane(packed: torch.Tensor, *, width: int = 4,
                 signed: bool) -> torch.Tensor:
    """Inverse of :func:`pack_plane`: (..., B) bytes -> (..., B*8/width)
    int8 field values; ``signed`` sign-extends each two's-complement
    field, unsigned gives ``[0, 2^width - 1]``."""
    if width not in PLANE_WIDTHS:
        raise ValueError(f"width must be one of {PLANE_WIDTHS}, got {width}")
    per = 8 // width
    b = packed.to(torch.int32) & 0xFF
    mask = (1 << width) - 1
    fields = []
    for i in range(per):
        f = (b >> (i * width)) & mask
        if signed:
            f = torch.where(f >= 1 << (width - 1), f - (1 << width), f)
        fields.append(f)
    out = torch.stack(fields, dim=-1)
    return out.reshape(*packed.shape[:-1],
                       packed.shape[-1] * per).to(torch.int8)

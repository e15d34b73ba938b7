"""SPARQLe packed sub-precision wire format, torch twin of
``repro.core.packing``.

``core/sparqle.py`` splits int8 activations into nibble planes carried
in full int8 containers; this module is the wire format the paper's
Eq. 1 accounts for, with exact pack/unpack inverses:

  * **LSB4 plane** — two nibbles per byte: byte ``j`` of a row holds
    column ``2j`` low and ``2j+1`` high (``qlinear.pack_int4``'s order).
  * **PBM words** — the precision bitmap in 32-bit words: bit ``i`` of
    word ``w`` is the PBM of column ``32*w + i``. JAX holds them as
    uint32; here they are the same bit patterns in int32 (torch's uint32
    is thin), so bit 31 makes a word negative and no arithmetic on a
    word may assume a sign — compare them as ``np.uint32`` views.
  * **MSB stream** — only the nonzero MSB4 nibbles, compacted in column
    order two per byte and indexed by the bitmap; the container is
    worst-case sized (K/2 bytes a row), ``wire_bytes`` counts the bytes
    in use.

Padding rule: the logical K axis is zero-padded to a multiple of
``K_ALIGN = 32`` before packing; padded columns encode as 0 with PBM 0.
The packed matmul kernel takes the two nibble planes packed two per byte
(``planes_packed``), not the stream. The module also carries the
width-k plane codec of the KV2 tier (``pack_plane``/``unpack_plane``)
and the row-wise wire accounting of the serving telemetry. Every
function runs on its input's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.sparqle import SparqleActivation

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


def pack_nibbles(nib: torch.Tensor) -> torch.Tensor:
    """(..., K even) nibble values -> (..., K/2) bytes: byte ``j`` is
    ``nib[2j] & 0xF | (nib[2j+1] & 0xF) << 4``; unsigned LSB4 and signed
    MSB4 values pack alike. :func:`pack_plane` at width 4."""
    return pack_plane(nib, width=4)


def unpack_nibbles(packed: torch.Tensor, *, signed: bool) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`; ``signed`` sign-extends (MSB4),
    unsigned gives [0, 15] (LSB4)."""
    return unpack_plane(packed, width=4, signed=signed)


def pack_pbm(pbm: torch.Tensor) -> torch.Tensor:
    """(..., K mult of 32) bool -> (..., K/32) int32 words holding the
    uint32 bit patterns (bit i of word w = column 32w + i)."""
    if pbm.shape[-1] % PBM_WORD_BITS:
        raise ValueError(f"last dim {pbm.shape[-1]} is not a multiple of "
                         f"{PBM_WORD_BITS}")
    bits = pbm.reshape(*pbm.shape[:-1], -1, PBM_WORD_BITS).to(torch.int64)
    shift = torch.arange(PBM_WORD_BITS, device=pbm.device)
    words = (bits << shift).sum(dim=-1)               # [0, 2**32) in int64
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_pbm(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_pbm`, sliced to ``k`` logical columns."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shift = torch.arange(PBM_WORD_BITS, device=words.device)
    bits = (w[..., None] >> shift) & 1
    flat = bits.reshape(*words.shape[:-1], words.shape[-1] * PBM_WORD_BITS)
    return flat[..., :k].to(torch.bool)


def compact_msb(msb4: torch.Tensor, pbm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nonzero MSB4 nibbles of (M, K) planes compacted in column
    order: (stream (M, K/2) int8 two per byte, count (M,) int32).
    Nibbles past a row's count are zero."""
    m, k = msb4.shape
    dest = torch.where(pbm, torch.cumsum(pbm.to(torch.int64), dim=1) - 1, k)
    nib = torch.zeros((m, k + 1), dtype=torch.int8, device=msb4.device)
    nib.scatter_(1, dest, (msb4 & 0xF).to(torch.int8))  # column k: dropped
    return (pack_nibbles(nib[:, :k]),
            pbm.sum(dim=1, dtype=torch.int32))


def expand_msb(stream: torch.Tensor, pbm: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compact_msb`: the dense sign-extended MSB4
    plane (M, K) from the stream and the bitmap."""
    k = pbm.shape[1]
    nib = unpack_nibbles(stream, signed=True)
    idx = torch.clamp(torch.cumsum(pbm.to(torch.int64), dim=1) - 1, 0, k - 1)
    return torch.where(pbm, torch.gather(nib, 1, idx),
                       torch.zeros_like(nib)).to(torch.int8)


@dataclasses.dataclass
class PackedSparqleActivation:
    """An int8 activation tensor in the packed wire format. Tensors cover
    the padded layout (``pad_k(K)`` columns); ``shape`` is the logical
    (M, K)."""

    lsb4: torch.Tensor        # (M, Kp/2) int8, two LSB nibbles per byte
    pbm: torch.Tensor         # (M, Kp/32) int32, uint32 bit patterns
    msb_stream: torch.Tensor  # (M, Kp/2) int8, compacted MSB nibbles
    msb_count: torch.Tensor   # (M,) int32, nibbles in use per row
    scale: torch.Tensor       # f32 activation scale
    shape: Tuple[int, int] = (0, 0)

    def wire_bytes(self) -> torch.Tensor:
        """Measured bytes on the wire (a 0-d int64 tensor): LSB plane +
        PBM words + ``ceil(popcount/2)`` stream bytes per row."""
        m = self.lsb4.shape[0]
        fixed = m * self.lsb4.shape[-1] + m * self.pbm.shape[-1] * 4
        return fixed + torch.div(self.msb_count.to(torch.int64) + 1, 2,
                                 rounding_mode="floor").sum()

    def container_bytes(self) -> int:
        """Bytes of the containers (worst-case MSB stream)."""
        return (self.lsb4.numel() + self.pbm.numel() * 4
                + self.msb_stream.numel() + self.msb_count.numel() * 4)

    def dense_bytes(self) -> int:
        """Bytes of the dense int8 tensor this encodes."""
        m, k = self.shape
        return m * k


def encode_packed(x_int8: torch.Tensor,
                  scale: Union[torch.Tensor, float] = 1.0
                  ) -> PackedSparqleActivation:
    """int8 (M, K) -> packed wire format. Exact for every int8 input."""
    x = x_int8.to(torch.int8)
    if x.ndim != 2:
        raise ValueError(f"expected (M, K), got {tuple(x.shape)}")
    xp = torch.nn.functional.pad(x, (0, pad_k(x.shape[1]) - x.shape[1]))
    msb4 = xp >> 4
    pbm = msb4 != 0
    stream, count = compact_msb(msb4, pbm)
    return PackedSparqleActivation(
        lsb4=pack_nibbles(xp & 0xF), pbm=pack_pbm(pbm), msb_stream=stream,
        msb_count=count,
        scale=torch.as_tensor(scale, dtype=torch.float32, device=x.device),
        shape=tuple(x.shape))


def _padded_pbm(p: PackedSparqleActivation) -> torch.Tensor:
    return unpack_pbm(p.pbm, p.lsb4.shape[-1] * 2)


def decode_packed(p: PackedSparqleActivation) -> torch.Tensor:
    """Packed wire format -> int8 (M, K); inverse of :func:`encode_packed`."""
    msb4 = expand_msb(p.msb_stream, _padded_pbm(p))
    lsb4 = unpack_nibbles(p.lsb4, signed=False)
    x = msb4.to(torch.int32) * 16 + lsb4.to(torch.int32)
    return x.to(torch.int8)[:, :p.shape[1]]


def planes_packed(p: PackedSparqleActivation
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed matmul's operands: (LSB4, MSB4) nibble planes, both
    (M, Kp/2) two per byte; the MSB plane re-expanded from the stream."""
    return p.lsb4, pack_nibbles(expand_msb(p.msb_stream, _padded_pbm(p)))


def unpack_planes(p: PackedSparqleActivation) -> SparqleActivation:
    """Packed wire format -> the dense-plane :class:`SparqleActivation`,
    sliced to the logical shape."""
    k = p.shape[1]
    pbm = _padded_pbm(p)
    return SparqleActivation(
        lsb4=unpack_nibbles(p.lsb4, signed=False)[:, :k],
        msb4=expand_msb(p.msb_stream, pbm)[:, :k], pbm=pbm[:, :k],
        scale=p.scale)


def predicted_wire_bytes(n: int, sparsity: float, *, width: int = 4
                         ) -> float:
    """Generalised Eq. 1: ``n * (width/8 + 1/8 + (1 - s) * (8-width)/8)``
    predicted wire bytes of ``n`` int8 elements at high-plane sparsity
    ``s``; ignores the padding slack :func:`measured_wire_bytes_rows`
    counts."""
    if width not in PLANE_WIDTHS:
        raise ValueError(f"width must be one of {PLANE_WIDTHS}, got {width}")
    return n * (width / 8 + 1 / 8 + (1.0 - sparsity) * (8 - width) / 8)

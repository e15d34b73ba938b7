"""SPARQLe activation codec (paper §3.1), torch twin of ``repro.core.sparqle``.

An int8 tensor splits into ``lsb4`` (low nibble, 0..15), ``msb4``
(arithmetic high nibble, -8..7) and ``pbm`` (True where msb4 != 0), with
``x == msb4 * 16 + lsb4`` exactly. :func:`compression_percent` and
:func:`encoded_bytes` are Eq. 1's analytical prediction of the wire
bytes (``core/packing.py`` measures them), :func:`ops_reduction_percent`
Eq. 2.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# MSB4==0 range for two's-complement int8 (paper §3.2): [lp_l, lp_h].
LP_LOW = 0
LP_HIGH = 15


@dataclasses.dataclass
class SparqleActivation:
    lsb4: torch.Tensor   # int8, values in [0, 15]
    msb4: torch.Tensor   # int8, values in [-8, 7]
    pbm: torch.Tensor    # bool
    scale: torch.Tensor  # f32

    @property
    def shape(self):
        return tuple(self.lsb4.shape)


def encode(x_int8: torch.Tensor, scale=1.0) -> SparqleActivation:
    """int8 tensor -> (LSB4, MSB4, PBM). Exact for all int8 inputs."""
    x = x_int8.to(torch.int8)
    msb4 = x >> 4
    lsb4 = x & 0xF
    return SparqleActivation(lsb4=lsb4, msb4=msb4, pbm=msb4 != 0,
                             scale=torch.as_tensor(scale, dtype=torch.float32))


def decode(a: SparqleActivation) -> torch.Tensor:
    """(LSB4, MSB4, PBM) -> int8 tensor. Inverse of :func:`encode`."""
    return (a.msb4.to(torch.int32) * 16 + a.lsb4.to(torch.int32)).to(
        torch.int8)


def fraction(mask: torch.Tensor, axis=None) -> torch.Tensor:
    """f32 mean of a bool tensor (scalar, or along ``axis``) as XLA forms
    ``jnp.mean``: the exact count times the f32 reciprocal of the element
    count (``Tensor.mean`` rounds differently for some counts)."""
    ones = mask.float()
    n = ones.numel() if axis is None else ones.shape[axis]
    count = ones.sum() if axis is None else ones.sum(dim=axis)
    return count * (1.0 / n)


def subprecision_sparsity(x_int8: torch.Tensor, axis=None) -> torch.Tensor:
    """Fraction of elements whose MSB4 is zero (scalar, or along ``axis``)."""
    return fraction((x_int8.to(torch.int8) >> 4) == 0, axis)


def tile_population(pbm: torch.Tensor, tile_m: int,
                    tile_k: int) -> torch.Tensor:
    """Per-(M-tile, K-tile) nonzero-MSB4 counts, int32 (M/tile_m, K/tile_k).

    Requires divisible shapes, as the JAX function does.
    """
    m, k = pbm.shape
    if m % tile_m or k % tile_k:
        raise ValueError(f"{tuple(pbm.shape)} not divisible by "
                         f"({tile_m}, {tile_k})")
    t = pbm.reshape(m // tile_m, tile_m, k // tile_k, tile_k)
    return t.to(torch.int32).sum(dim=(1, 3), dtype=torch.int32)


def compression_percent(s, p: int = 8) -> torch.Tensor:
    """Paper Eq. 1: storage saved vs a dense p-bit tensor, f32.

    dense p bits/elem vs (p/2 LSB bits + 1 PBM bit + (1-s)*p/2 MSB bits).
    For p=8 this evaluates to (4s-1)/8 * 100.
    """
    s = torch.as_tensor(s, dtype=torch.float32)
    kept = p / 2 + 1 + (1 - s) * p / 2
    return (p - kept) / p * 100.0


def ops_reduction_percent(s) -> torch.Tensor:
    """Paper Eq. 2: fraction of int4-MAC work skipped by the sparse pass."""
    return torch.as_tensor(s, dtype=torch.float32) / 2.0 * 100.0


def encoded_bytes(shape: Tuple[int, ...], s: float, p: int = 8) -> float:
    """Eq. 1 analytical prediction of the compressed wire bytes of an
    ``s``-sparse tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= d
    return n * (p / 2 + 1 + (1 - s) * p / 2) / 8.0


def tile_sparsity(pbm: torch.Tensor, tile_m: int,
                  tile_k: int) -> torch.Tensor:
    """Fraction of (tile_m x tile_k) MSB4 tiles that are entirely zero."""
    return fraction(tile_population(pbm, tile_m, tile_k) == 0)

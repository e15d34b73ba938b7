"""Plain PyTorch versions of the three Hopper kernels of the serving path.

These are the numerical contracts. The CPU path of every wrapper runs
them; ``chip_smoke.py`` and the ``cuda``-marked tests hold each kernel
against its function here, on the same inputs, on the card. They run on
any device: integer products go through float64, which is exact for
these magnitudes (|acc| < 2**31 << 2**53), because CUDA has no integer
``torch.matmul``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparqle import LP_HIGH, LP_LOW, tile_population

# Tile of the PBM population the matmul skips its MSB pass on. TILE_K
# matches the clipping mask's tile_k, so clipped column blocks line up
# with skippable tiles; TILE_M is the matmul's rows per block.
TILE_M = 16
TILE_K = 128

NEG_INF = -2.0e38
_MIN_SCALE = torch.finfo(torch.float32).tiny


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_population_padded(pbm: torch.Tensor, tile_m: int = TILE_M,
                           tile_k: int = TILE_K) -> torch.Tensor:
    """PBM population per (tile_m, tile_k) tile, ragged edges zero-padded:
    int32 (ceil(M/tile_m), ceil(K/tile_k))."""
    m, k = pbm.shape
    padded = torch.nn.functional.pad(
        pbm.to(torch.int32), (0, (-k) % tile_k, 0, (-m) % tile_m))
    return tile_population(padded, tile_m, tile_k)


def sparqle_encode_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    scale: torch.Tensor,               # (M, 1) f32 per-token scale
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize -> [clip] -> split: (lsb4, msb4, pbm, tile_pop).

    The quotient ``x / scale`` is rounded to x's dtype before
    ``round`` (half to even), as ``quantize_activations`` forms it in
    the activation's dtype; scales below f32 ``tiny`` divide by 1.
    """
    s = scale.float()
    s = torch.where(s.abs() < _MIN_SCALE, torch.ones_like(s), s)
    v = (x.float() / s).to(x.dtype).float()
    q = torch.clamp(torch.round(v), -128, 127).to(torch.int32)
    if col_mask is not None:
        lo = col_mask & (q >= int(l)) & (q < LP_LOW)
        hi = col_mask & (q > LP_HIGH) & (q <= int(h))
        q = torch.where(lo, LP_LOW, torch.where(hi, LP_HIGH, q))
    q = q.to(torch.int8)
    msb = q >> 4
    lsb = q & 0xF
    pbm = msb != 0
    return lsb, msb, pbm, tile_population_padded(pbm)


def unpack_int4_k(w_packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8 packed along K (``qlinear.pack_int4``) -> (K, N)."""
    lo = (w_packed << 4) >> 4
    hi = w_packed >> 4
    return torch.stack([lo, hi], dim=1).reshape(-1, w_packed.shape[-1])


def sparqle_matmul_ref(
    lsb4: torch.Tensor,        # (M, K) int8
    msb4: torch.Tensor,        # (M, K) int8
    tile_pop: torch.Tensor,    # (ceil(M/TILE_M), ceil(K/TILE_K)) int32
    w_packed: torch.Tensor,    # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,   # (M, 1) f32
    w_scale: torch.Tensor,     # (1, N) f32
    acc_out: bool = False,
) -> torch.Tensor:
    """Dual pass: acc = lsb @ w + 16 * (msb @ w) with the MSB tiles whose
    population is 0 skipped (exact: such a tile's MSB plane is zero);
    drain ``acc.f32 * act_scale * w_scale`` or the raw int32 acc."""
    del tile_pop  # skipping is exact; the plain version computes all tiles
    w = unpack_int4_k(w_packed).to(torch.float64)
    dense = lsb4.to(torch.float64) @ w
    sparse = msb4.to(torch.float64) @ w
    acc = (dense + 16.0 * sparse).to(torch.int32)
    if acc_out:
        return acc
    return acc.float() * act_scale.float() * w_scale.float()


def unpack_kv4(p: torch.Tensor) -> torch.Tensor:
    """(..., hd/2) packed KV nibbles (adjacent hd pairs) -> (..., hd)."""
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def kv4_paged_decode_attention_ref(
    q: torch.Tensor,              # (B, KVH, G, hd)
    k_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    v_pages: torch.Tensor,
    v_scale_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, Pmax) int32
    pos: torch.Tensor,            # (B,) int32
) -> torch.Tensor:
    """Decode attention over the paged packed-KV4 pool, f32 softmax."""
    b, kvh, g, hd = q.shape
    _, ps, _, _ = k_pages.shape
    n_s = block_tables.shape[1]
    tables = block_tables.long()

    def gather(pages, scales):
        x = unpack_kv4(pages[tables]).float() * scales[tables][..., None]
        return x.reshape(b, n_s * ps, kvh, hd)

    k = gather(k_pages, k_scale_pages)
    v = gather(v_pages, v_scale_pages)
    s = torch.einsum("bhgd,bjhd->bhgj", q.float(), k) * hd ** -0.5
    allow = (torch.arange(n_s * ps, device=q.device)[None, :]
             <= pos.long()[:, None])
    s = torch.where(allow[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgj,bjhd->bhgd", p, v)
    return out.to(q.dtype)

"""Plain PyTorch versions of the Hopper kernels of the serving path.

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

from repro_torch.core.packing import (pack_nibbles, pack_pbm, pad_k,
                                      unpack_nibbles, unpack_plane)
from repro_torch.core.quantize import activation_scale
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


def sparqle_quantize_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    scale: torch.Tensor,               # (M, 1) f32 per-token scale
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> torch.Tensor:
    """Quantize -> [clip]: the int8 activation q (M, K).

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
    return q.to(torch.int8)


def sparqle_encode_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    scale: torch.Tensor,               # (M, 1) f32 per-token scale
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize -> [clip] -> split: (lsb4, msb4, pbm, tile_pop)."""
    q = sparqle_quantize_ref(x, scale, col_mask, l, h)
    msb = q >> 4
    lsb = q & 0xF
    pbm = msb != 0
    return lsb, msb, pbm, tile_population_padded(pbm)


def sparqle_encode_packed_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    scale: torch.Tensor,               # (M, 1) f32 per-token scale
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize -> [clip] -> split -> pack: (lsb4, msb4) packed two per
    byte (M, pad_k(K)/2) int8, PBM words (M, pad_k(K)/32) int32 (uint32
    bit patterns) and tile_pop as :func:`sparqle_encode_ref`'s. Padded
    columns encode as 0 with PBM 0."""
    q = sparqle_quantize_ref(x, scale, col_mask, l, h)
    pop = tile_population_padded((q >> 4) != 0)
    qp = torch.nn.functional.pad(q, (0, pad_k(q.shape[1]) - q.shape[1]))
    msb = qp >> 4
    return pack_nibbles(qp & 0xF), pack_nibbles(msb), pack_pbm(msb != 0), pop


def sparqle_encode_fused_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The fused-scale encoder: (lsb4, msb4, pbm, tile_pop, scale) with
    the per-token scale ``activation_scale(x).float()`` (M, 1) f32."""
    scale = activation_scale(x).float()
    return (*sparqle_encode_ref(x, scale, col_mask, l, h), scale)


def sparqle_quantize_fused_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused-scale quantize-only form: (q int8, scale (M, 1) f32)."""
    scale = activation_scale(x).float()
    return sparqle_quantize_ref(x, scale, col_mask, l, h), scale


def sparqle_encode_packed_fused_ref(
    x: torch.Tensor,                   # (M, K) f32 / bf16
    col_mask: Optional[torch.Tensor] = None,   # (K,) bool
    l: int = 0,
    h: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The fused-scale packed encoder: (lsb4, msb4, pbm words, tile_pop,
    scale), the planes as :func:`sparqle_encode_packed_ref`'s."""
    scale = activation_scale(x).float()
    return (*sparqle_encode_packed_ref(x, scale, col_mask, l, h), scale)


def unpack_int4_k(w_packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8 packed along K (``qlinear.pack_int4``) -> (K, N)."""
    lo = (w_packed << 4) >> 4
    hi = w_packed >> 4
    return torch.stack([lo, hi], dim=1).reshape(-1, w_packed.shape[-1])


def sparqle_matmul_ref(
    lsb4: torch.Tensor,                 # (M, K) int8
    msb4: Optional[torch.Tensor],       # (M, K) int8
    tile_pop: Optional[torch.Tensor],   # (ceil(M/TILE_M), ceil(K/TILE_K))
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    acc_out: bool = False,
    msb_skip: bool = False,
) -> torch.Tensor:
    """Dual pass: acc = lsb @ w + 16 * (msb @ w) with the MSB tiles whose
    population is 0 skipped (exact: such a tile's MSB plane is zero);
    drain ``acc.f32 * act_scale * w_scale`` or the raw int32 acc.
    ``msb_skip``: the LSB4-only draft, acc = lsb @ w (msb4 and tile_pop
    are not read and may be None)."""
    del tile_pop  # skipping is exact; the plain version computes all tiles
    w = unpack_int4_k(w_packed).to(torch.float64)
    acc = lsb4.to(torch.float64) @ w
    if not msb_skip:
        acc = acc + 16.0 * (msb4.to(torch.float64) @ w)
    acc = acc.to(torch.int32)
    if acc_out:
        return acc
    return acc.float() * act_scale.float() * w_scale.float()


def sparqle_matmul_packed_ref(
    lsb4_packed: torch.Tensor,          # (M, pad_k(K)/2) int8
    msb4_packed: Optional[torch.Tensor],
    tile_pop: Optional[torch.Tensor],
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    acc_out: bool = False,
    msb_skip: bool = False,
) -> torch.Tensor:
    """:func:`sparqle_matmul_ref` on nibble planes packed two per byte
    (the wire layout, K padded to a multiple of 32): unpacked (LSB
    unsigned, MSB sign-extended) and cut to the weight's K first."""
    k = w_packed.shape[0] * 2
    lsb = unpack_nibbles(lsb4_packed, signed=False)[:, :k]
    msb = (None if msb_skip
           else unpack_nibbles(msb4_packed, signed=True)[:, :k])
    return sparqle_matmul_ref(lsb, msb, tile_pop, w_packed, act_scale,
                              w_scale, acc_out=acc_out, msb_skip=msb_skip)


def quant_matmul_ref(
    q: torch.Tensor,                    # (M, K) int8
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    acc_out: bool = False,
) -> torch.Tensor:
    """Dense single pass: acc = q @ w in int32; drain ``acc.f32 *
    act_scale * w_scale`` or the raw acc. Since q = 16 * msb4 + lsb4
    exactly, acc equals the dual pass's accumulator bit for bit."""
    w = unpack_int4_k(w_packed).to(torch.float64)
    acc = (q.to(torch.float64) @ w).to(torch.int32)
    if acc_out:
        return acc
    return acc.float() * act_scale.float() * w_scale.float()


def batched(fn):
    """The expert-batched form of a 2-D plain version: ``fn`` on each
    expert's operands (every tensor argument carries a leading E axis;
    None and Python values are shared), each output stacked along a new
    leading E axis. The batched kernel entries' contract: one expert's
    slice of their result is the 2-D entry's result on its slices."""
    def run(*args, **kw):
        e = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
        outs = [fn(*[a[i] if isinstance(a, torch.Tensor) else a
                     for a in args], **kw) for i in range(e)]
        if isinstance(outs[0], tuple):
            return tuple(None if parts[0] is None else torch.stack(parts)
                         for parts in zip(*outs))
        return torch.stack(outs)
    run.__name__ = f"batched_{fn.__name__}"
    return run


def plain_for(fn, expert_batched: bool):
    """The plain version a wrapper runs on the CPU: ``fn``, or its
    expert-batched form for operands with a leading expert axis."""
    return batched(fn) if expert_batched else fn


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
    tables = block_tables.long()
    k = _gather_pages(k_pages, k_scale_pages, tables, unpack_kv4)
    v = _gather_pages(v_pages, v_scale_pages, tables, unpack_kv4)
    return decode_attention_f32(q, k, v, pos)


def kv4_decode_attention_ref(
    q: torch.Tensor,        # (B, KVH, G, hd)
    k_q: torch.Tensor,      # (B, S, KVH, hd/2) int8
    k_s: torch.Tensor,      # (B, S, KVH) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    pos: torch.Tensor,      # (B,) int32
    round_kv: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over the contiguous packed-KV4 cache, f32
    softmax, positions j <= pos and, with a sliding ``window`` (0: none),
    pos - j < window. ``round_kv`` with a bf16 q: every
    dequantized K and V element is rounded to bf16 before it is used,
    as JAX's fixed-batch decode dequantizes into the activation dtype
    (no effect on an f32 q)."""
    k = unpack_kv4(k_q).float() * k_s[..., None]
    v = unpack_kv4(v_q).float() * v_s[..., None]
    if round_kv and q.dtype == torch.bfloat16:
        k, v = k.to(q.dtype).float(), v.to(q.dtype).float()
    return decode_attention_f32(q, k, v, pos, window)


def kv4_decode_attention_partial_ref(
    q: torch.Tensor,        # (B, KVH, G, hd)
    k_q: torch.Tensor,      # (B, S, KVH, hd/2) int8: positions start..
    k_s: torch.Tensor,      # (B, S, KVH) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    pos: torch.Tensor,      # (B,) int32, global
    start: int = 0,
    round_kv: bool = False,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode attention over a slice of the contiguous cache whose first
    token is global position ``start``: keys start + j <= pos and, with a
    ``window``, pos - (start + j) < window. Returns the attention over
    those keys in f32 (B, KVH, G, hd) and the log-sum-exp of their scaled
    scores (B, KVH, G) f32; a query with no key in the slice gets 0 and
    -inf (:func:`merge_partials` then drops it)."""
    k = unpack_kv4(k_q).float() * k_s[..., None]
    v = unpack_kv4(v_q).float() * v_s[..., None]
    if round_kv and q.dtype == torch.bfloat16:
        k, v = k.to(q.dtype).float(), v.to(q.dtype).float()
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bjhd->bhgj", q.float(), k) * hd ** -0.5
    j = start + torch.arange(k.shape[1], device=q.device)[None, :]
    p_ = pos.long()[:, None]
    allow = (j <= p_)
    if window:
        allow = allow & ((p_ - j) < window)
    allow = allow[:, None, None, :]
    s = torch.where(allow, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    live = torch.isfinite(lse)
    p = torch.where(allow, torch.exp(s - torch.where(
        live, lse, 0.0)[..., None]), 0.0)
    out = torch.einsum("bhgj,bjhd->bhgd", p, v)
    return out, lse


def merge_partials(outs, lses) -> torch.Tensor:
    """The attention over every slice from each slice's (out, lse) of
    :func:`kv4_decode_attention_partial_ref` (in f32): the max of the
    lse, then the sum of exp(lse - max) * out over that of exp(lse -
    max), the merge the mesh decode all-reduces."""
    lse = torch.stack(lses)
    mx = lse.amax(dim=0)
    w = torch.exp(lse - mx)
    num = sum(wi[..., None] * o for wi, o in zip(w, outs))
    return num / w.sum(dim=0)[..., None]


def _gather_pages(pages, scales, tables, unpack) -> torch.Tensor:
    """The pages ``tables`` (B, Pmax) names, dequantized in f32:
    (B, Pmax * ps, KVH, hd)."""
    b, n_s = tables.shape
    _, ps, kvh, _ = pages.shape
    x = unpack(pages[tables]).float() * scales[tables][..., None]
    return x.reshape(b, n_s * ps, kvh, -1)


def decode_attention_f32(q, k, v, pos, window: int = 0) -> torch.Tensor:
    """f32 attention of q (B, KVH, G, hd) over dequantized k/v
    (B, S, KVH, hd), masked to positions j <= pos and, with a sliding
    ``window``, pos - j < window; output in q's dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bjhd->bhgj", q.float(), k) * hd ** -0.5
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    allow = j <= pos.long()[:, None]
    if window:
        allow = allow & ((pos.long()[:, None] - j) < window)
    s = torch.where(allow[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgj,bjhd->bhgd", p, v)
    return out.to(q.dtype)


def kv_tiered_paged_decode_attention_ref(
    q: torch.Tensor,               # (B, KVH, G, hd)
    k_pages: torch.Tensor,         # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,   # (P, ps, KVH) f32
    v_pages: torch.Tensor,
    v_scale_pages: torch.Tensor,
    k2_pages: torch.Tensor,        # (P2, ps, KVH, hd/4) int8
    k2_scale_pages: torch.Tensor,  # (P2, ps, KVH) f32
    v2_pages: torch.Tensor,
    v2_scale_pages: torch.Tensor,
    block_tables: torch.Tensor,    # (B, Pmax) int32
    tier_tables: torch.Tensor,     # (B, Pmax) int32, 0 = KV4, 1 = KV2
    pos: torch.Tensor,             # (B,) int32
) -> torch.Tensor:
    """Mixed-tier decode attention: page i of sequence b comes from the
    KV2 slab when ``tier_tables[b, i] == 1``, else from the KV4 slab
    (the other slab is read at its null page and discarded). A KV2 byte
    holds four signed 2-bit fields, field i of byte j being element
    4j+i. On tier-0 pages the dequantized values, hence the result, are
    those of :func:`kv4_paged_decode_attention_ref`."""
    tables = block_tables.long()
    kv2 = (tier_tables == 1)
    t4 = torch.where(kv2, 0, tables)
    t2 = torch.where(kv2, tables, 0)
    ps = k_pages.shape[1]
    sel = torch.repeat_interleave(kv2, ps, dim=1)[:, :, None, None]

    def unpack_kv2(p):
        return unpack_plane(p, width=2, signed=True)

    def gather(p4, s4, p2, s2):
        return torch.where(sel, _gather_pages(p2, s2, t2, unpack_kv2),
                           _gather_pages(p4, s4, t4, unpack_kv4))

    k = gather(k_pages, k_scale_pages, k2_pages, k2_scale_pages)
    v = gather(v_pages, v_scale_pages, v2_pages, v2_scale_pages)
    return decode_attention_f32(q, k, v, pos)


def kv4_paged_verify_attention_ref(
    q: torch.Tensor,              # (B, T, KVH, G, hd)
    k_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    v_pages: torch.Tensor,
    v_scale_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, Pmax) int32
    pos: torch.Tensor,            # (B,) int32, position of window token 0
) -> torch.Tensor:
    """Multi-token verify attention, stated as its contract: window token
    t of sequence b is a decode query at ``pos[b] + t``, attending to
    cache positions ``<= pos[b] + t``. Returns (B, T, KVH, G, hd)."""
    return torch.stack([
        kv4_paged_decode_attention_ref(
            q[:, t], k_pages, k_scale_pages, v_pages, v_scale_pages,
            block_tables, pos + t)
        for t in range(q.shape[1])], dim=1)

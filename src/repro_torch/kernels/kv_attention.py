"""Paged packed-KV4 flash-decode attention: split-KV flash decoding.

Replaces the Pallas kernel ``repro/kernels/kv_attention.py``
``kv4_paged_decode_attention`` (``_paged_kernel`` -> ``_flash_step`` ->
``_dequant4_block`` + ``_flash_core``) with the CUDA kernel in
``csrc/kv_attention.cu``. Bound on the H100 by bytes: each sequence's
pages are read once in their wire format (two nibbles per byte plus one
f32 scale per token and head); both products run on the tensor cores
(bf16 MMAs of the exact nibbles against q and p split into three bf16
terms each, f32 accumulate). The pages of each query group are
split across the blocks of a thread-block cluster and, inside a block,
across its warps (:func:`split_plan`, a pure function of the table
width); each warp runs the online softmax over its pages, and the
partial states merge in warp order, then in cluster-rank order through
distributed shared memory. The G query heads of a group share every
page load; the kernel stops at the page holding ``pos``.

``kv4_paged_verify_attention`` replaces the Pallas
``kv4_paged_verify_attention`` (``_paged_verify_kernel``): the T-token
window of speculative verification, window token t at query position
``pos + t``; it is the decode kernel launched with T tokens a sequence,
so its output is bit-exact with T decode calls.
``kv_tiered_paged_decode_attention`` replaces the Pallas
``kv_tiered_paged_decode_attention`` (``_tiered_paged_kernel``): the
KV2 precision ladder's read path, a per-page tier table that sends a
demoted page to the KV2 slab (four 2-bit fields per byte), read at its
own width, in a template instance of the same body whose float
operations are the decode kernel's: a tiered call over tier-0 pages
gives one decode call's bits (held on the card).

``kv4_decode_attention`` replaces the Pallas ``kv4_decode_attention``
(``_kernel``): decode over the contiguous (B, S, KVH, hd/2) cache of the
fixed-batch path, read in blocks of ``bs`` tokens as the page pool
(B*S/bs, bs, KVH, hd/2) with the implicit table ``b*S/bs + i``, by an
instance of the same body: bit-exact with the paged kernel on pages of
``bs`` that tile the same cache (held on the card). ``round_kv=True``
(what ``models.model.attn_decode`` passes) runs a third instance that
rounds each dequantized K and V element to bf16 first when q is bf16,
as JAX's fixed-batch decode does. ``window`` (gemma3's local layers)
masks keys more than ``window - 1`` behind pos and reads only the blocks
the window spans (``csrc/kv_attention.cu``); its calls and the hd-256
instance (paligemma-3b) count apart (``kv_attention_contiguous_window``,
``kv_attention_contiguous_hd256``).

``kv4_decode_attention_partial`` (row 7p) is the contiguous decode over
a SLICE of the cache whose first token is global position ``start``
(the ``--legacy`` decode on a mesh whose cache is cut along its
positions): it returns the attention over the slice's live keys in f32
and their log-sum-exp, -inf for a query with none, and the slices merge
by ``kernels.ref.merge_partials`` (``models/model.py`` all-reduces
the max and the weighted sums). On the card it is the contiguous
kernel's instance with the slice's first position and an lse output
(``kv4_decode_partial_launch``), counted apart; its plain version is
``kv4_decode_attention_partial_ref``.

On the card the kernels take a head dim in ``HEAD_DIMS`` (one template
instance each; 256 keeps its cp.async rings in dynamic shared memory), pages of any size (16, the engine's default, has its own
compile-time instance; the kernel walks a page in tiles of 16 token
rows) and any G (the query heads go to the blocks ``GQ`` at a time, the
last block's heads past G masked); the wrappers raise on another head
dim. A CUDA tensor goes to the kernel (or raises); a CPU
tensor goes to the plain version
(``kernels.ref.kv4_paged_decode_attention_ref``,
``kv4_paged_verify_attention_ref``,
``kv_tiered_paged_decode_attention_ref``, ``kv4_decode_attention_ref``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (kv4_decode_attention_partial_ref,
                                     kv4_decode_attention_ref,
                                     kv4_paged_decode_attention_ref,
                                     kv4_paged_verify_attention_ref,
                                     kv_tiered_paged_decode_attention_ref)

KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_paged_decode_launch",
    [_build.P, _build.I] + [_build.P] * 7 + [_build.I] * 6 + [_build.P]))
VERIFY_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_paged_verify_launch",
    [_build.P, _build.I] + [_build.P] * 7 + [_build.I] * 7 + [_build.P],
    name="kv_attention_verify"))
TIERED_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv_tiered_paged_decode_launch",
    [_build.P, _build.I] + [_build.P] * 12 + [_build.I] * 6 + [_build.P],
    name="kv_attention_tiered"))
_CONTIGUOUS_ARGS = [_build.P, _build.I] + [_build.P] * 6 + [_build.I] * 8 + [
    _build.P]
CONTIGUOUS_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_decode_launch", _CONTIGUOUS_ARGS,
    name="kv_attention_contiguous"))
# The contiguous kernel's sliding-window calls (gemma3's local layers) and
# its hd-256 instance (paligemma-3b), counted apart: the same entry point.
CONTIGUOUS_WINDOW_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_decode_launch", _CONTIGUOUS_ARGS,
    name="kv_attention_contiguous_window"))
CONTIGUOUS_HD256_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_decode_launch", _CONTIGUOUS_ARGS,
    name="kv_attention_contiguous_hd256"))
# row 7p: the contiguous kernel on a slice of the cache, its own entry
PARTIAL_KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_decode_partial_launch",
    [_build.P, _build.I] + [_build.P] * 7 + [_build.I] * 9 + [_build.P],
    name="kv_attention_partial"))

# The kernel's compile-time shape (``csrc/kv_attention.cu``): the head
# dims it is instantiated for, token rows a tile (the page size of its
# compile-time instance), query heads a block, warps a block, blocks a
# cluster.
HEAD_DIMS = (16, 32, 64, 128, 256)
TILE_ROWS, GQ, WARPS, MAX_CLUSTER = 16, 4, 4, 8

# Tokens per cache block of the contiguous kernel: the engine's page
# size, so that the fixed-batch and the paged decode give the same bits.
CONTIGUOUS_BLOCK = TILE_ROWS


class SplitPlan(NamedTuple):
    """How the kernel splits a query group's NS pages: ``pages_per_warp``
    consecutive pages a warp, ``pages_per_block`` (WARPS of those) a
    block, ``cluster`` blocks."""
    pages_per_warp: int
    pages_per_block: int
    cluster: int


def split_plan(n_s: int) -> SplitPlan:
    """The kernel's ``split_plan``: a pure function of the table width
    ``n_s`` (never of B, T, the grid or the tiers), so that calls that
    read the same pages through tables of one width merge alike."""
    if n_s < 1:
        raise ValueError(f"table width {n_s} < 1")
    ppw = -(-n_s // (WARPS * MAX_CLUSTER))
    ppb = WARPS * ppw
    return SplitPlan(ppw, ppb, -(-n_s // ppb))


def window_span(n_s: int, ps: int, window: int) -> int:
    """The kernel's ``window_span``: the most blocks of ``ps`` tokens a
    window of ``window`` keys touches, at most the table width. A
    sequence whose window starts past block 0 splits its live blocks by
    ``split_plan(window_span(...))``; a windowed call launches the
    larger cluster of that plan and ``split_plan(n_s)``."""
    return min(n_s, (window + ps - 2) // ps + 1)


def page_owner(plan: SplitPlan, i: int) -> Tuple[int, int]:
    """(cluster rank, warp) that reads page ``i`` of a sequence."""
    return i // plan.pages_per_block, (i % plan.pages_per_block
                                       ) // plan.pages_per_warp


def _check_card_shape(hd: int, tensors) -> None:
    """Raise unless the card's kernel takes this head dim and each page
    tensor starts aligned to its copy size: rows arrive in chunks of
    min(16, row bytes)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes hd in {HEAD_DIMS}, "
                         f"got hd={hd}")
    for t in tensors:
        if t.data_ptr() % min(16, t.shape[-1]):
            raise ValueError(f"page tensors must be aligned to "
                             f"{min(16, t.shape[-1])} bytes")


def _check(q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           pos, kv2=()) -> None:
    """Raise unless the operands are what the kernels take; ``kv2`` is
    the tiered kernel's (k2_pages, k2_scale_pages, v2_pages,
    v2_scale_pages, tier_tables)."""
    hd = q.shape[-1]
    n_pages, ps, kvh, hdp = k_pages.shape
    b, n_s = block_tables.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    operands = [
        ("q", q, (b, *q.shape[1:-3], kvh, q.shape[-2], hd), q.dtype),
        ("k_pages", k_pages, (n_pages, ps, kvh, hd // 2), torch.int8),
        ("v_pages", v_pages, (n_pages, ps, kvh, hd // 2), torch.int8),
        ("k_scale_pages", k_scale_pages, (n_pages, ps, kvh), torch.float32),
        ("v_scale_pages", v_scale_pages, (n_pages, ps, kvh), torch.float32),
        ("block_tables", block_tables, (b, n_s), torch.int32),
        ("pos", pos, (b,), torch.int32)]
    if kv2:
        if hd % 4:
            raise ValueError(f"the KV2 slab packs 4 fields per byte: hd={hd}")
        k2, k2s, v2, v2s, tiers = kv2
        n2 = k2.shape[0]
        operands += [
            ("k2_pages", k2, (n2, ps, kvh, hd // 4), torch.int8),
            ("v2_pages", v2, (n2, ps, kvh, hd // 4), torch.int8),
            ("k2_scale_pages", k2s, (n2, ps, kvh), torch.float32),
            ("v2_scale_pages", v2s, (n2, ps, kvh), torch.float32),
            ("tier_tables", tiers, (b, n_s), torch.int32)]
    for name, t, shape, dt in operands:
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hdp * 2 != hd:
        raise ValueError(f"packed head dim {hdp} != hd/2 for hd={hd}")


def _like_q(q: torch.Tensor, *args) -> torch.Tensor:
    return torch.empty_like(q)


def _paged_launch(kernel, q, pages, block_tables, pos, *dims) -> torch.Tensor:
    """One launch of a paged entry: q, its page tensors in the entry's
    order, the table, pos, then ``dims``; the output like q."""
    hd, ps, n_s = q.shape[-1], pages[0].shape[1], block_tables.shape[1]
    _check_card_shape(hd, (pages[0], pages[2]))
    out = torch.empty_like(q)
    if q.numel() and n_s:
        kernel.launch(q.data_ptr(), int(q.dtype == torch.bfloat16),
                      *(t.data_ptr() for t in pages),
                      block_tables.data_ptr(), pos.data_ptr(),
                      out.data_ptr(), *dims, hd, ps, n_s)
    return out


@_build.kernel_op("kv4_paged_decode_attention", _like_q,
                  kv4_paged_decode_attention_ref)
def DECODE_OP(q: torch.Tensor, k_pages: torch.Tensor,
              k_scale_pages: torch.Tensor, v_pages: torch.Tensor,
              v_scale_pages: torch.Tensor, block_tables: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    b, kvh, g, _ = q.shape
    return _paged_launch(KERNEL, q, (k_pages, k_scale_pages, v_pages,
                                     v_scale_pages), block_tables, pos,
                         b, kvh, g)


@_build.kernel_op("kv4_paged_verify_attention", _like_q,
                  kv4_paged_verify_attention_ref)
def VERIFY_OP(q: torch.Tensor, k_pages: torch.Tensor,
              k_scale_pages: torch.Tensor, v_pages: torch.Tensor,
              v_scale_pages: torch.Tensor, block_tables: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    b, t, kvh, g, _ = q.shape
    return _paged_launch(VERIFY_KERNEL, q, (k_pages, k_scale_pages, v_pages,
                                            v_scale_pages), block_tables,
                         pos, b, t, kvh, g)


def _tiered_fake(q: torch.Tensor, k_pages: torch.Tensor,
                 k_scale_pages: torch.Tensor, v_pages: torch.Tensor,
                 v_scale_pages: torch.Tensor, k2_pages: torch.Tensor,
                 k2_scale_pages: torch.Tensor, v2_pages: torch.Tensor,
                 v2_scale_pages: torch.Tensor, block_tables: torch.Tensor,
                 tier_tables: torch.Tensor, pos: torch.Tensor
                 ) -> torch.Tensor:
    return torch.empty_like(q)


@_build.kernel_op("kv_tiered_paged_decode_attention", _tiered_fake,
                  kv_tiered_paged_decode_attention_ref)
def TIERED_OP(q: torch.Tensor, k_pages: torch.Tensor,
              k_scale_pages: torch.Tensor, v_pages: torch.Tensor,
              v_scale_pages: torch.Tensor, k2_pages: torch.Tensor,
              k2_scale_pages: torch.Tensor, v2_pages: torch.Tensor,
              v2_scale_pages: torch.Tensor, block_tables: torch.Tensor,
              tier_tables: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    b, kvh, g, hd = q.shape
    ps, n_s = k_pages.shape[1], block_tables.shape[1]
    _check_card_shape(hd, (k_pages, v_pages, k2_pages, v2_pages))
    out = torch.empty_like(q)
    if b and kvh and n_s:
        TIERED_KERNEL.launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16),
            *(t.data_ptr() for t in (k_pages, k_scale_pages, v_pages,
                                     v_scale_pages, k2_pages,
                                     k2_scale_pages, v2_pages,
                                     v2_scale_pages, block_tables,
                                     tier_tables, pos)),
            out.data_ptr(), b, kvh, g, hd, ps, n_s)
    return out


def _contiguous_fake(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                     v_q: torch.Tensor, v_s: torch.Tensor, pos: torch.Tensor,
                     bs: int, round_kv: bool, window: int) -> torch.Tensor:
    return torch.empty_like(q)


def _contiguous_plain(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                      v_q: torch.Tensor, v_s: torch.Tensor,
                      pos: torch.Tensor, bs: int, round_kv: bool,
                      window: int) -> torch.Tensor:
    return kv4_decode_attention_ref(q, k_q, k_s, v_q, v_s, pos,
                                    round_kv=round_kv, window=window)


@_build.kernel_op("kv4_decode_attention", _contiguous_fake,
                  _contiguous_plain)
def CONTIGUOUS_OP(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                  v_q: torch.Tensor, v_s: torch.Tensor, pos: torch.Tensor,
                  bs: int, round_kv: bool, window: int) -> torch.Tensor:
    b, kvh, g, hd = q.shape
    n_s = k_q.shape[1] // bs
    _check_card_shape(hd, (k_q, v_q))
    out = torch.empty_like(q)
    kernel = (CONTIGUOUS_WINDOW_KERNEL if window else
              CONTIGUOUS_HD256_KERNEL if hd == 256 else CONTIGUOUS_KERNEL)
    if b and kvh and n_s:
        kernel.launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, kvh, g, hd, bs, n_s, int(round_kv),
            int(window))
    return out


def _partial_outputs(q: torch.Tensor) -> List[torch.Tensor]:
    return [torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)]


def _partial_fake(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                  v_q: torch.Tensor, v_s: torch.Tensor, pos: torch.Tensor,
                  start: int, round_kv: bool, window: int
                  ) -> List[torch.Tensor]:
    return _partial_outputs(q)


def _partial_plain(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                   v_q: torch.Tensor, v_s: torch.Tensor, pos: torch.Tensor,
                   start: int, round_kv: bool, window: int
                   ) -> List[torch.Tensor]:
    return list(kv4_decode_attention_partial_ref(
        q, k_q, k_s, v_q, v_s, pos, start=start, round_kv=round_kv,
        window=window))


@_build.kernel_op("kv4_decode_attention_partial", _partial_fake,
                  _partial_plain)
def PARTIAL_OP(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
               v_q: torch.Tensor, v_s: torch.Tensor, pos: torch.Tensor,
               start: int, round_kv: bool, window: int
               ) -> List[torch.Tensor]:
    b, kvh, g, hd = q.shape
    s = k_q.shape[1]
    bs = math.gcd(s, CONTIGUOUS_BLOCK)
    _check_card_shape(hd, (k_q, v_q))
    out, lse = _partial_outputs(q)
    if b and kvh and s:
        PARTIAL_KERNEL.launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), pos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, kvh, g, hd, bs, s // bs,
            int(start), int(round_kv), int(window))
    return [out, lse]


def kv4_paged_decode_attention(
    q: torch.Tensor,              # (B, KVH, G, hd) f32 / bf16
    k_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    v_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    v_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    block_tables: torch.Tensor,   # (B, Pmax) int32
    pos: torch.Tensor,            # (B,) int32
) -> torch.Tensor:
    """(B, KVH, G, hd) attention output in q's dtype."""
    if not _build.on_card(q):
        return kv4_paged_decode_attention_ref(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages,
            block_tables, pos)
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KVH, G, hd), got {tuple(q.shape)}")
    _check(q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           pos)
    return DECODE_OP(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                     block_tables, pos)


def kv4_paged_verify_attention(
    q: torch.Tensor,              # (B, T, KVH, G, hd) f32 / bf16
    k_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    v_pages: torch.Tensor,        # (P, ps, KVH, hd/2) int8
    v_scale_pages: torch.Tensor,  # (P, ps, KVH) f32
    block_tables: torch.Tensor,   # (B, Pmax) int32
    pos: torch.Tensor,            # (B,) int32, position of window token 0
) -> torch.Tensor:
    """(B, T, KVH, G, hd) attention output in q's dtype; window token t
    attends to cache positions <= pos + t (the caller has written the
    window's K/V into the pages first)."""
    if not _build.on_card(q):
        return kv4_paged_verify_attention_ref(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages,
            block_tables, pos)
    if q.ndim != 5:
        raise ValueError(f"q must be (B, T, KVH, G, hd), got "
                         f"{tuple(q.shape)}")
    _check(q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           pos)
    return VERIFY_OP(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                     block_tables, pos)


def kv_tiered_paged_decode_attention(
    q: torch.Tensor,               # (B, KVH, G, hd) f32 / bf16
    k_pages: torch.Tensor,         # (P, ps, KVH, hd/2) int8
    k_scale_pages: torch.Tensor,   # (P, ps, KVH) f32
    v_pages: torch.Tensor,         # (P, ps, KVH, hd/2) int8
    v_scale_pages: torch.Tensor,   # (P, ps, KVH) f32
    k2_pages: torch.Tensor,        # (P2, ps, KVH, hd/4) int8
    k2_scale_pages: torch.Tensor,  # (P2, ps, KVH) f32
    v2_pages: torch.Tensor,        # (P2, ps, KVH, hd/4) int8
    v2_scale_pages: torch.Tensor,  # (P2, ps, KVH) f32
    block_tables: torch.Tensor,    # (B, Pmax) int32
    tier_tables: torch.Tensor,     # (B, Pmax) int32, 0 = KV4, 1 = KV2
    pos: torch.Tensor,             # (B,) int32
) -> torch.Tensor:
    """(B, KVH, G, hd) attention output in q's dtype; ``block_tables[b,
    i]`` indexes the slab ``tier_tables[b, i]`` names."""
    args = (q, k_pages, k_scale_pages, v_pages, v_scale_pages, k2_pages,
            k2_scale_pages, v2_pages, v2_scale_pages, block_tables,
            tier_tables, pos)
    if not _build.on_card(q):
        return kv_tiered_paged_decode_attention_ref(*args)
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KVH, G, hd), got {tuple(q.shape)}")
    _check(q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           pos, kv2=(k2_pages, k2_scale_pages, v2_pages, v2_scale_pages,
                     tier_tables))
    return TIERED_OP(*args)


def kv4_decode_attention(
    q: torch.Tensor,        # (B, KVH, G, hd) f32 / bf16
    k_q: torch.Tensor,      # (B, S, KVH, hd/2) int8
    k_s: torch.Tensor,      # (B, S, KVH) f32
    v_q: torch.Tensor,      # (B, S, KVH, hd/2) int8
    v_s: torch.Tensor,      # (B, S, KVH) f32
    pos: torch.Tensor,      # (B,) int32
    *,
    bs: int = CONTIGUOUS_BLOCK,
    round_kv: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """(B, KVH, G, hd) attention output in q's dtype over the contiguous
    cache, positions j <= pos and, with a sliding ``window`` (0: none),
    pos - j < window, in blocks of ``bs`` tokens (S must be a multiple
    of ``bs``). ``round_kv`` with a bf16 q rounds each dequantized K and
    V element to bf16 first (JAX's fixed-batch decode); the default
    reads them in f32, the Pallas kernel's contract, and is bit-exact
    with the paged kernel. A window reads only the blocks it spans;
    one that does not bind (window >= pos + 1) gives window 0's bits."""
    if not _build.on_card(q):
        return kv4_decode_attention_ref(q, k_q, k_s, v_q, v_s, pos,
                                        round_kv=round_kv, window=window)
    if q.ndim != 4 or k_q.ndim != 4:
        raise ValueError(f"q must be (B, KVH, G, hd) and k_q (B, S, KVH, "
                         f"hd/2), got {tuple(q.shape)}, {tuple(k_q.shape)}")
    b, kvh, g, hd = q.shape
    s = k_q.shape[1]
    if bs <= 0 or s % bs:
        raise ValueError(f"cache length {s} is not a multiple of the block "
                         f"size {bs}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    for name, t, shape, dt in (
            ("q", q, (b, kvh, g, hd), q.dtype),
            ("k_q", k_q, (b, s, kvh, hd // 2), torch.int8),
            ("v_q", v_q, (b, s, kvh, hd // 2), torch.int8),
            ("k_s", k_s, (b, s, kvh), torch.float32),
            ("v_s", v_s, (b, s, kvh), torch.float32),
            ("pos", pos, (b,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name}: expected {dt} {shape} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes hd in {HEAD_DIMS}, "
                         f"got hd={hd}")
    return CONTIGUOUS_OP(q, k_q, k_s, v_q, v_s, pos, bs, round_kv, window)


def kv4_decode_attention_partial(
    q: torch.Tensor,        # (B, KVH, G, hd) f32 / bf16
    k_q: torch.Tensor,      # (B, S, KVH, hd/2) int8: positions start..
    k_s: torch.Tensor,      # (B, S, KVH) f32
    v_q: torch.Tensor,      # (B, S, KVH, hd/2) int8
    v_s: torch.Tensor,      # (B, S, KVH) f32
    pos: torch.Tensor,      # (B,) int32, global
    *,
    start: int = 0,
    round_kv: bool = False,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 7p: decode attention over a slice of the contiguous cache
    whose first token is global position ``start`` (the rank's slice of
    a cache cut along its positions), ``pos`` and ``window`` in global
    positions. Returns (the attention over the slice's live keys, f32
    (B, KVH, G, hd); the log-sum-exp of their scaled scores, f32 (B, KVH,
    G)); a query with no live key in the slice gets 0 and -inf. The
    slices' results merge by ``kernels.ref.merge_partials`` (the mesh
    decode: one MAX and one SUM all-reduce). The contiguous kernel's
    instances, in blocks of the largest divisor of S it shares with
    ``CONTIGUOUS_BLOCK``."""
    if not _build.on_card(q):
        return kv4_decode_attention_partial_ref(
            q, k_q, k_s, v_q, v_s, pos, start=start, round_kv=round_kv,
            window=window)
    if q.ndim != 4 or k_q.ndim != 4:
        raise ValueError(f"q must be (B, KVH, G, hd) and k_q (B, S, KVH, "
                         f"hd/2), got {tuple(q.shape)}, {tuple(k_q.shape)}")
    b, kvh, g, hd = q.shape
    s = k_q.shape[1]
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    for name, t, shape, dt in (
            ("k_q", k_q, (b, s, kvh, hd // 2), torch.int8),
            ("v_q", v_q, (b, s, kvh, hd // 2), torch.int8),
            ("k_s", k_s, (b, s, kvh), torch.float32),
            ("v_s", v_s, (b, s, kvh), torch.float32),
            ("pos", pos, (b,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name}: expected {dt} {shape} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes hd in {HEAD_DIMS}, "
                         f"got hd={hd}")
    out, lse = PARTIAL_OP(q, k_q, k_s, v_q, v_s, pos, int(start),
                          bool(round_kv), int(window))
    return out, lse

"""Paged packed-KV4 flash-decode attention.

Replaces the Pallas kernel ``repro/kernels/kv_attention.py``
``kv4_paged_decode_attention`` (``_paged_kernel`` -> ``_flash_step`` ->
``_dequant4_block`` + ``_flash_core``) with the CUDA kernel in
``csrc/kv_attention.cu``. Bound on the H100 by bytes: each sequence's
pages are read once in their wire format (two nibbles per byte plus one
f32 scale per token and head). One block per (sequence, KV head) shares
each page between the G query heads of the group, dequantizes it in
shared memory, and stops at the page holding ``pos``.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.kv4_paged_decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kv4_paged_decode_attention_ref

KERNEL = _build.register(_build.Kernel(
    "kv_attention.cu", "kv4_paged_decode_launch",
    [_build.P, _build.I] + [_build.P] * 7 + [_build.I] * 6 + [_build.P]))


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
    if not q.is_cuda:
        return kv4_paged_decode_attention_ref(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages,
            block_tables, pos)
    b, kvh, g, hd = q.shape
    n_pages, ps, _, hdp = k_pages.shape
    n_s = block_tables.shape[1]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    for name, t, shape, dt in (
            ("q", q, (b, kvh, g, hd), q.dtype),
            ("k_pages", k_pages, (n_pages, ps, kvh, hd // 2), torch.int8),
            ("v_pages", v_pages, (n_pages, ps, kvh, hd // 2), torch.int8),
            ("k_scale_pages", k_scale_pages, (n_pages, ps, kvh),
             torch.float32),
            ("v_scale_pages", v_scale_pages, (n_pages, ps, kvh),
             torch.float32),
            ("block_tables", block_tables, (b, n_s), torch.int32),
            ("pos", pos, (b,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hdp * 2 != hd:
        raise ValueError(f"packed head dim {hdp} != hd/2 for hd={hd}")
    out = torch.empty_like(q)
    if b and kvh and n_s:
        KERNEL.launch(q.data_ptr(), int(q.dtype == torch.bfloat16),
                      k_pages.data_ptr(), k_scale_pages.data_ptr(),
                      v_pages.data_ptr(), v_scale_pages.data_ptr(),
                      block_tables.data_ptr(), pos.data_ptr(),
                      out.data_ptr(), b, kvh, g, hd, ps, n_s)
    return out

"""Mixture-of-Experts FFN on one device (torch twin of the single-device
parts of ``repro.models.moe``): softmax/sigmoid top-k routing, the
sort-based dispatch into an (E, C, D) capacity buffer, the batched
expert SwiGLU and the inverse-permutation combine, plus the always-on
shared experts and training's load-balance loss. The expert-parallel
forms (``moe_ffn_local_ep``, ``moe_ffn_dist``'s shard_map branch) are not
ported: on one device ``moe_ffn_dist`` is :func:`moe_ffn`.

Every step is a device op on static shapes (capacity is a function of
the token count only), with no host read, so the steps that run it
capture as CUDA graphs. The routed expert projections go through
:func:`repro_torch.core.qlinear.expert_linear`: for a served tree on the
card one batched encoder launch and one batched matmul launch each, for
all E experts; for a float (training) tree one batched product.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.qlinear import expert_linear, linear
from repro_torch.models.layers import silu, softmax


def router(x: torch.Tensor, w_router: torch.Tensor, router_type: str,
           top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (weights (T, k) f32, expert ids (T, k)). The logits are
    a full-f32 product (the card's float32 matmul runs without TF32 by
    default: ``torch.backends.cuda.matmul.allow_tf32`` stays False). Ties
    in the top k are broken by ``torch.topk``'s order, which on the card
    is not promised to be ``lax.top_k``'s (lowest index first)."""
    logits = x.float() @ w_router.float()
    if router_type == "sigmoid":
        topv, topi = torch.topk(torch.sigmoid(logits), top_k, dim=-1)
        return topv / topv.sum(-1, keepdim=True).clamp_min(1e-9), topi
    return torch.topk(softmax(logits), top_k, dim=-1)


def load_balance_loss(x: torch.Tensor, w_router: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss over x (T, D), as JAX's:
    f32 router logits, softmax, the top-k assignment counts (exact
    integers; no gradient flows through them), ``e * sum(frac_tokens *
    frac_probs)``."""
    probs = softmax(x.float() @ w_router.float())
    e = probs.shape[-1]
    topi = torch.topk(probs, top_k, dim=-1)[1]
    counts = torch.bincount(topi.reshape(-1), minlength=e).float()
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    frac_probs = probs.mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.0) -> int:
    """Capacity slots an expert: ``max(1, int(T k cf) // E)``."""
    return max(1, int(tokens * top_k * capacity_factor) // n_experts)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate, w_up, w_down,
            *, top_k: int, capacity_factor: float = 1.0,
            router_type: str = "softmax") -> torch.Tensor:
    """Routed experts on x (T, D): each token's top-k assignments sorted
    by expert (a stable sort, so an expert takes its tokens in token
    order), ranked within their expert, kept below capacity (the rest go
    to an overflow row and add nothing), run through the (E, C, D)
    buffer's SwiGLU and combined per token in f32, then cast to x's
    dtype."""
    t, d = x.shape
    e = w_router.shape[-1]
    cap = capacity(t, top_k, e, capacity_factor)
    topv, topi = router(x, w_router, router_type, top_k)

    flat_e = topi.reshape(-1)                       # (T k,) expert ids
    flat_w = topv.reshape(-1).float()
    flat_t = torch.arange(t * top_k, device=x.device) // top_k
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # rank within expert = index - first index of this expert id
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(t * top_k, device=x.device) - first
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, e * cap))  # dropped -> overflow

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]      # kept slots are distinct; the overflow row
    expert_in = buf[:-1].reshape(e, cap, d)            # is dropped
    h = silu(expert_linear(expert_in, w_gate))
    h = h * expert_linear(expert_in, w_up)
    # row-parallel under TP (experts shard on their hidden dim): one int32
    # all-reduce keeps the combine the single-device one
    expert_out = expert_linear(h, w_down, tp="row")

    # combine through the inverse permutation (gathers only): x's dtype
    # times the f32 weights promotes to f32, as in JAX; the top-k sum in
    # order, then the cast back
    inv_order = torch.argsort(order)
    gathered = expert_out.reshape(e * cap, d)[slot.clamp_max(e * cap - 1)]
    gathered = gathered * (sw * keep)[:, None]
    per_assignment = gathered[inv_order].reshape(t, top_k, d)
    return per_assignment.sum(dim=1).to(x.dtype)


def shared_expert_ffn(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Always-on shared experts: one wide SwiGLU over (..., D)."""
    return linear(silu(linear(x, w_gate)) * linear(x, w_up), w_down,
                  tp="row")

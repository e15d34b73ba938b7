"""Mixture-of-Experts FFN (torch twin of ``repro.models.moe``):
softmax/sigmoid top-k routing, the sort-based dispatch into an (E, C, D)
capacity buffer, the batched expert SwiGLU and the inverse-permutation
combine, plus the always-on shared experts and training's load-balance
loss; and the expert-parallel forms of mesh training,
:func:`moe_ffn_local_ep` (a model rank's own experts on its data rank's
rows, one f32 SUM all-reduce over model combining the partials) and
:func:`moe_ffn_dist` (the reference's choice between it, in 16,384-token
chunks, and :func:`moe_ffn` on the data ranks' rows gathered when the
experts do not shard over the model axis).

Every step is a device op on static shapes (capacity is a function of
the token count only), with no host read, so the steps that run it
capture as CUDA graphs. The routed expert projections go through
:func:`repro_torch.core.qlinear.expert_linear`: for a served tree on the
card one batched encoder launch and one batched matmul launch each, for
all E experts; for a float (training) tree one batched product.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

import torch.distributed as dist

from repro_torch.core.qlinear import expert_linear, linear
from repro_torch.distributed.tp import (copy_to, gather_rows, model_input,
                                        reduce_from, tp_ctx)
from repro_torch.models.layers import silu, softmax

# moe_ffn_dist's chunk: bounds the local dispatch buffers to ~chunk k D
EP_CHUNK = 16384


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
                      top_k: int, count_group=None) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss over x (T, D), as JAX's:
    f32 router logits, softmax, the top-k assignment counts (exact
    integers; no gradient flows through them), ``e * sum(frac_tokens *
    frac_probs)``. With ``count_group`` (a data-sharded train step) the
    counts are all-reduced over it, so ``frac_tokens`` is the global
    batch's and the mean of the ranks' losses is the global loss (and
    the mean of their grads its grad)."""
    probs = softmax(x.float() @ w_router.float())
    e = probs.shape[-1]
    topi = torch.topk(probs, top_k, dim=-1)[1]
    idx = topi.reshape(-1)         # counted into e bins (a static shape)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device
                         ).index_add_(0, idx, torch.ones(
                             idx.shape, dtype=torch.float32,
                             device=x.device))
    if count_group is not None:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=count_group)
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    frac_probs = probs.mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.0) -> int:
    """Capacity slots an expert: ``max(1, int(T k cf) // E)``."""
    return max(1, int(tokens * top_k * capacity_factor) // n_experts)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate, w_up, w_down,
            *, top_k: int, capacity_factor: float = 1.0,
            router_type: str = "softmax",
            down_tp: Optional[str] = "row", expert_lo: int = 0,
            sum_group=None) -> torch.Tensor:
    """Routed experts on x (T, D): each token's top-k assignments sorted
    by expert (a stable sort, so an expert takes its tokens in token
    order), ranked within their expert, kept below capacity (the rest go
    to an overflow row and add nothing), run through the (E, C, D)
    buffer's SwiGLU and combined per token in f32, then cast to x's
    dtype. ``down_tp``: the down projection's TP mark (serving shards the
    experts on their hidden dim; a train step's replicated experts pass
    None). Expert weights holding fewer experts than the router routes
    to are a serving mesh rank's [``expert_lo``, ``expert_lo`` + E_local)
    on the expert axis: the routing and capacity stay the whole
    program's, only the rank's experts' slots are filled and run, and
    the per-token f32 partial sums are summed over ``sum_group``."""
    t, d = x.shape
    e = w_router.shape[-1]
    e_loc = (w_gate.w.q if hasattr(w_gate, "w") else w_gate).shape[0]
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
    if e_loc != e:     # a mesh rank's experts: the others' slots dropped
        keep = keep & (se >= expert_lo) & (se < expert_lo + e_loc)
        se = se - expert_lo
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, e_loc * cap))  # -> overflow

    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]      # kept slots are distinct; the overflow row
    expert_in = buf[:-1].reshape(e_loc, cap, d)        # is dropped
    h = silu(expert_linear(expert_in, w_gate))
    h = h * expert_linear(expert_in, w_up)
    # row-parallel under TP (experts shard on their hidden dim): one int32
    # all-reduce keeps the combine the single-device one
    expert_out = expert_linear(h, w_down, tp=down_tp)

    # combine through the inverse permutation (gathers only): x's dtype
    # times the f32 weights promotes to f32, as in JAX; the top-k sum in
    # order, then the cast back
    inv_order = torch.argsort(order)
    gathered = expert_out.reshape(e_loc * cap, d)[
        slot.clamp_max(e_loc * cap - 1)]
    gathered = gathered * (sw * keep)[:, None]
    per_assignment = gathered[inv_order].reshape(t, top_k, d)
    y = per_assignment.sum(dim=1)
    if sum_group is not None:
        y = y.float()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=sum_group)
    return y.to(x.dtype)


def moe_ffn_local_ep(x_l: torch.Tensor, w_router: torch.Tensor, w_gate,
                     w_up, w_down, *, top_k: int, e_total: int,
                     model_rank: int, group,
                     capacity_factor: float = 1.0,
                     router_type: str = "softmax") -> torch.Tensor:
    """The expert-parallel body on a data rank's rows x_l (T_local, D):
    this model rank owns experts [model_rank E_local, (model_rank + 1)
    E_local) (``w_gate``/``w_up``/``w_down`` are theirs), routes against
    the whole router, dispatches only the assignments that hit its own
    experts (foreign ones go to the overflow row, as dropped ones do),
    with capacity ``max(1, int(T_local k cf) // E_total)``, runs its
    experts, combines its partial output per token in f32, and one f32
    SUM all-reduce over the model ``group`` gives the whole combine (the
    reference's ``psum``). At one data rank it keeps and drops exactly
    the assignments :func:`moe_ffn` does. The caller passes x_l and the
    router through copy-to-model (their grads here are partial)."""
    t, d = x_l.shape
    e_local = w_gate.shape[0]
    off = model_rank * e_local
    cap = capacity(t, top_k, e_total, capacity_factor)
    topv, topi = router(x_l, w_router, router_type, top_k)

    flat_g = topi.reshape(-1)                        # global expert ids
    mine = (flat_g >= off) & (flat_g < off + e_local)
    flat_e = torch.where(mine, flat_g - off, torch.full_like(flat_g,
                                                             e_local))
    flat_w = (topv.reshape(-1) * mine).float()
    flat_t = torch.arange(t * top_k, device=x_l.device) // top_k
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(t * top_k, device=x_l.device) - first
    keep = (rank < cap) & (se < e_local)
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, e_local * cap))  # -> overflow

    buf = torch.zeros((e_local * cap + 1, d), dtype=x_l.dtype,
                      device=x_l.device)
    buf[slot] = x_l[st]
    expert_in = buf[:-1].reshape(e_local, cap, d)
    h = silu(expert_linear(expert_in, w_gate))
    h = h * expert_linear(expert_in, w_up)
    expert_out = expert_linear(h, w_down)

    inv_order = torch.argsort(order)
    gathered = expert_out.reshape(e_local * cap, d)[
        slot.clamp_max(e_local * cap - 1)]
    gathered = gathered * (sw * keep)[:, None]
    y_partial = gathered[inv_order].reshape(t, top_k, d).sum(dim=1)
    return reduce_from(y_partial.float(), group).to(x_l.dtype)


def moe_ffn_dist(x: torch.Tensor, w_router: torch.Tensor, w_gate, w_up,
                 w_down, *, top_k: int, model_rank: int, model_ways: int,
                 group, capacity_factor: float = 1.0,
                 router_type: str = "softmax") -> torch.Tensor:
    """A train step's MoE on a data rank's rows x (T_local, D), by the
    reference's rules. Routed experts sharded on the expert axis (model
    ways > 1 dividing E): :func:`moe_ffn_local_ep` on x whole, or on each
    16,384-token chunk when EP_CHUNK divides a longer x (capacity then
    per chunk, as the reference's ``lax.map``); x and the router enter
    through copy-to-model. Otherwise the experts are whole on every model
    rank: the data ranks' rows gathered (``distributed.tp.gather_rows``),
    routed together with the global capacity by :func:`moe_ffn`, this
    rank's rows sliced back out."""
    e_total = w_router.shape[-1]
    if model_ways <= 1 or e_total % model_ways:
        t = x.shape[0]
        y = moe_ffn(gather_rows(x), w_router, w_gate, w_up, w_down,
                    top_k=top_k, capacity_factor=capacity_factor,
                    router_type=router_type, down_tp=None)
        lo = tp_ctx().data_rank * t if y.shape[0] != t else 0
        return y[lo:lo + t]
    x, w_router = copy_to(x, group), copy_to(w_router, group)

    def one(xi):
        return moe_ffn_local_ep(
            xi, w_router, w_gate, w_up, w_down, top_k=top_k,
            e_total=e_total, model_rank=model_rank, group=group,
            capacity_factor=capacity_factor, router_type=router_type)

    t = x.shape[0]
    if t <= EP_CHUNK or t % EP_CHUNK:
        return one(x)
    return torch.cat([one(x[c:c + EP_CHUNK])
                      for c in range(0, t, EP_CHUNK)])


def shared_expert_ffn(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Always-on shared experts: one wide SwiGLU over (..., D), column/row
    parallel under TP (the input through copy-to-model in a train
    step)."""
    x = model_input(x)
    return linear(silu(linear(x, w_gate)) * linear(x, w_up), w_down,
                  tp="row")

"""AdamW, its cosine schedule and gradient utilities (torch twin of
``repro.optim.adamw``):

  * moments stored in ``OptConfig.moment_dtype`` (bf16 by default: half
    the optimizer state);
  * global-norm clipping;
  * int8 error-feedback gradient compression (``compress_grads`` /
    ``decompress_grads``), the cross-pod all-reduce's payload.

Trees are nested dicts of tensors, walked in JAX's leaf order (sorted
keys). The arithmetic is the reference's, f32 op by op in its order; a
division by a number the reference divides by divides by a 0-d tensor of
it, since on the card a division by a Python number is a multiplication
by its reciprocal. The step is a 0-d int32 tensor on the params' device,
so a step reads nothing back to the host.

:func:`adamw_update` writes the new params and moments INTO the given
tensors (the JAX step donates its state; an f32 copy of starcoder2-3b's
state is 38 GB), one leaf at a time and a leaf above ``SLICE_BYTES`` a
run of its leading axis at a time, so its f32 temporaries stay one slice
wide; the bits are those of the out-of-place formula. Microbatch accumulation
lives in ``launch/steps.py``.

On a mesh each rank holds its slice of every leaf (``distributed/
sharding.py``): the global norm sums each piece once over the world (a
replicated leaf at one rank of each axis it is whole over: ``counted``),
and :func:`compress_grads` takes each leaf's scale from its global amax
(``global_amax``), so the int8 payload is the one-device payload's slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import flatten as tree_leaves
from repro_torch.checkpoint.store import unflatten

# A leaf larger than this (in f32) is updated a run of its leading
# (layer or row) axis at a time: starcoder2-3b's stacked w_fc is 4.53 GB.
SLICE_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "bfloat16"     # bf16 moments: half the opt-state

    @property
    def mdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.moment_dtype == "bfloat16"
                else torch.float32)


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Any              # first moment (tree, moment dtype)
    nu: Any              # second moment (tree, moment dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _slices(t: torch.Tensor) -> Iterator:
    """Indices that cover ``t``: the whole of it, or, when it is larger
    than SLICE_BYTES in f32, runs of its leading axis of at most
    SLICE_BYTES each (one index where a single one is larger): a stacked
    leaf's layers, or an embedding table's rows (deepseek-v3's 129,280 x
    7,168 is 3.7 GB)."""
    if t.ndim >= 2 and t.numel() * 4 > SLICE_BYTES:
        step = max(1, SLICE_BYTES // (t[0].numel() * 4))
        for i in range(0, t.shape[0], step):
            yield slice(i, i + step)
    else:
        yield slice(None)


def init_opt_state(params: Any, cfg: OptConfig) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.mdtype,  # noqa: E731
                                  device=p.device)
    first = tree_leaves(params)[0]
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` (f32)."""
    warm = torch.clamp(step.float() / _const(max(cfg.warmup_steps, 1), step),
                       max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _const(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(leaf[i].float()))
               for i in _slices(leaf))


def global_norm(tree: Any, counted: Optional[List] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum
    of squares; a leaf above SLICE_BYTES summed a slice at a time. With
    ``counted`` (a rank's slices of a sharded tree: one entry a leaf, as
    ``TrainShards.counts_norm`` gives: True, False, or (dim, [(offset,
    width)]) for the runs of the leaf to count) the counted sums are
    added and the total all-reduced over the world, so every rank holds
    the whole tree's norm."""
    leaves = tree_leaves(tree)
    if counted is None:
        return torch.sqrt(sum(_sum_squares(leaf) for leaf in leaves))
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf, c in zip(leaves, counted, strict=True):
        if c is True:
            total = total + _sum_squares(leaf)
        elif c:
            dim, runs = c
            for lo, n in runs:
                total = total + _sum_squares(leaf.narrow(dim, lo, n))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_const(max_norm, norm) / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: OptConfig, counted: Optional[List] = None
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on the f32 master params, IN PLACE: the params and
    the state's moments are overwritten (module docstring) and returned
    in a new ``OptState`` with the next step. The grads are clipped by
    their global norm on the fly, a slice at a time; ``counted``: a
    rank's slices of sharded trees (:func:`global_norm`)."""
    norm = global_norm(grads, counted)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.betas
    c1 = 1 - torch.pow(b1, step.float())
    c2 = 1 - torch.pow(b2, step.float())
    with torch.no_grad():
        for p, g, m, v in zip(*map(tree_leaves, (params, grads, state.mu,
                                                  state.nu))):
            for i in _slices(p):
                gs = g[i].float() * scale
                m_new = b1 * m[i].float() + (1 - b1) * gs
                v_new = b2 * v[i].float() + (1 - b2) * gs * gs
                pf = p[i].float()
                delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps) \
                    + cfg.weight_decay * pf
                p[i].copy_(pf - lr * delta)
                m[i].copy_(m_new)
                v[i].copy_(v_new)
    metrics = {"grad_norm": norm, "lr": lr}
    return params, OptState(step=step, mu=state.mu, nu=state.nu), metrics


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (cross-pod all-reduce shrink)
# ---------------------------------------------------------------------------

def compress_grads(grads: Any, error: Any = None, *,
                   global_amax: bool = False):
    """Quantize gradients to int8 with a per-leaf scale + error feedback.

    Returns (q_tree of {'q', 'scale'} leaves, new_error): the caller
    all-reduces the int8 payload (4x fewer bytes than f32), then
    :func:`decompress_grads`; ``error`` carries this step's quantization
    residual into the next. ``global_amax``: the leaves are a rank's
    slices of sharded grads; each leaf's amax is taken over the world
    (one MAX all-reduce of all of them), so its scale, and its int8
    payload, are the whole leaf's."""
    if error is None:
        error = tree_map(torch.zeros_like, grads)
    fed = tree_map(lambda g, e: g + e.to(g.dtype), grads, error)
    amaxes = [torch.max(torch.abs(g)) for g in tree_leaves(fed)]
    if global_amax:
        stacked = torch.stack(amaxes)
        dist.all_reduce(stacked, op=dist.ReduceOp.MAX)
        amaxes = list(stacked.unbind())

    def comp(g, amax):
        s = (amax + 1e-12) / _const(127.0, g)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        return {"q": q, "scale": s}, g - q.to(g.dtype) * s

    pairs = tree_map(comp, fed, unflatten(fed, amaxes))
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def decompress_grads(qtree: Any) -> Any:
    if isinstance(qtree, dict) and "q" in qtree and not isinstance(
            qtree["q"], dict):
        return qtree["q"].float() * qtree["scale"]
    return {k: decompress_grads(v) for k, v in qtree.items()}

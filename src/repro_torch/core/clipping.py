"""Sub-precision sparsity enhancement (paper §3.2, Algorithm 1), torch
twin of ``repro.core.clipping``.

Clipping pushes int8 activation values into the MSB4==0 range [0, 15]:
values in [l, 0) clip to 0, values in (15, h] clip to 15 — but only inside
the ``k``-percent least important activation columns, where the
importance of activation column j is the L1 norm of weight row j.

Serving uses the offline tile-aligned importance mask and the hard
integer-domain clip. Calibration has two modes, as in the JAX package:
``global_calibrate`` sweeps one (l, h) pair for the whole model, and
``learn_clipping_constants`` (Algorithm 1) trains per-layer (l, h) with
all weights frozen through the sigmoid-relaxed ``soft_clipping``, its
gradient taken by ``torch.autograd`` on the clip parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.sparqle import (LP_HIGH, LP_LOW, fraction,
                                     subprecision_sparsity)


def column_importance(w: torch.Tensor) -> torch.Tensor:
    """L1 norm of each weight row. ``w`` is (K, N) for an A(M,K) @ W(K,N)."""
    return w.abs().sum(dim=-1)


def importance_mask(w: torch.Tensor, k_percent: float) -> torch.Tensor:
    """Bool (K,) mask, True on the k% least-important activation columns."""
    imp = column_importance(w)
    kk = int(imp.shape[0] * k_percent / 100.0 + 0.5)
    if kk <= 0:
        return torch.zeros(imp.shape, dtype=torch.bool, device=w.device)
    return imp <= torch.sort(imp).values[kk - 1]


def importance_mask_tile_aligned(w: torch.Tensor, k_percent: float,
                                 tile_k: int) -> torch.Tensor:
    """Bool (K,) mask selecting the k% least important ``tile_k``-wide
    column blocks by block-summed importance."""
    imp = column_importance(w)
    k = imp.shape[0]
    pad = (-k) % tile_k
    imp_p = torch.cat([imp, imp.new_full((pad,), float("inf"))])
    blocks = imp_p.reshape(-1, tile_k).sum(dim=1)
    kk = int(blocks.shape[0] * k_percent / 100.0 + 0.5)
    if kk <= 0:
        return torch.zeros((k,), dtype=torch.bool, device=w.device)
    thresh = torch.sort(blocks).values[kk - 1]
    return torch.repeat_interleave(blocks <= thresh, tile_k)[:k]


def apply_clipping(x_int: torch.Tensor, col_mask: torch.Tensor, l, h
                   ) -> torch.Tensor:
    """Hard clip in the integer domain: [l, 0) -> 0, (15, h] -> 15 on the
    masked columns; values outside [l, h] untouched."""
    x = x_int.to(torch.int32)
    clip_lo, clip_hi = _clip_regions(x, col_mask, l, h)
    y = torch.where(clip_lo, LP_LOW, torch.where(clip_hi, LP_HIGH, x))
    return y.to(x_int.dtype)


def _clip_regions(x_int: torch.Tensor, col_mask: torch.Tensor, l, h):
    x = x_int.to(torch.int32)
    clip_lo = col_mask & (x >= int(l)) & (x < LP_LOW)
    clip_hi = col_mask & (x > LP_HIGH) & (x <= int(h))
    return clip_lo, clip_hi


def clip_fraction(x_int: torch.Tensor, col_mask: torch.Tensor, l, h
                  ) -> torch.Tensor:
    """Fraction of elements the (l, h) clip actually moves (the mask of
    Eq. 3), f32."""
    clip_lo, clip_hi = _clip_regions(x_int, col_mask, l, h)
    return fraction(clip_lo | clip_hi)


def soft_clipping(x_int: torch.Tensor, col_mask: torch.Tensor,
                  l: torch.Tensor, h: torch.Tensor, tau: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable relaxation used by Algorithm 1: (clipped
    activations, soft clip mask). The sigmoid gates pass gradients to l
    and h; at tau -> 0 this converges to :func:`apply_clipping`."""
    x = x_int.float()
    in_lo_region = (x < LP_LOW).float()
    in_hi_region = (x > LP_HIGH).float()
    m_lo = torch.sigmoid((x - l) / tau) * in_lo_region * col_mask
    m_hi = torch.sigmoid((h - x) / tau) * in_hi_region * col_mask
    y = x * (1.0 - m_lo - m_hi) + m_lo * LP_LOW + m_hi * LP_HIGH
    return y, m_lo + m_hi


@dataclasses.dataclass
class SweepResult:
    l: int
    h: int
    error: float       # calibration MSE between clipped and base outputs
    sparsity: float    # resulting mean sub-precision sparsity
    score: float       # sparsity - lam * normalized error


def global_calibrate(
    eval_fn: Callable[[int, int], Tuple[float, float]],
    l_candidates=(-4, -8, -12, -16, -24, -32),
    h_candidates=(19, 23, 31, 39, 47, 63),
    lam: float = 10.0,
) -> SweepResult:
    """Sweep (l, h); ``eval_fn(l, h) -> (mse, sparsity)`` on calibration
    data. Picks the candidate maximizing ``sparsity - lam * mse_norm``,
    the error normalized by the largest in f32 as the JAX package does."""
    results = []
    for l in l_candidates:
        for h in h_candidates:
            mse, sp = eval_fn(int(l), int(h))
            results.append((int(l), int(h), float(mse), float(sp)))
    errs = torch.tensor([r[2] for r in results], dtype=torch.float32)
    norm = float(torch.clamp_min(errs.max(), 1e-12))
    best = None
    for (l, h, mse, sp) in results:
        score = sp - lam * mse / norm
        if best is None or score > best.score:
            best = SweepResult(l=l, h=h, error=mse, sparsity=sp, score=score)
    return best


ClipParams = Dict[str, torch.Tensor]  # {"l": (n_layers,), "h": (n_layers,)}


def init_clip_params(n_layers: int, l0: float = -8.0, h0: float = 23.0,
                     device="cpu") -> ClipParams:
    return {"l": torch.full((n_layers,), l0, dtype=torch.float32,
                            device=device),
            "h": torch.full((n_layers,), h0, dtype=torch.float32,
                            device=device)}


def learn_clipping_constants(
    apply_clip: Callable[[ClipParams, torch.Tensor],
                         Tuple[torch.Tensor, torch.Tensor]],
    apply_base: Callable[[torch.Tensor], torch.Tensor],
    dataset,
    clip_params: ClipParams,
    *,
    epochs: int = 23,
    lr: float = 0.5,
    alpha: float = 0.05,
) -> Tuple[ClipParams, list]:
    """Algorithm 1 (paper §3.2).

    ``apply_clip(params, batch) -> (outputs, mean_clip_mask)`` runs the
    model with sigmoid-relaxed clipping; ``apply_base(batch)`` runs the
    frozen base model. Only ``clip_params`` receive gradients (leaf
    tensors with ``requires_grad``, differentiated by ``torch.autograd``);
    loss is Eq. 3: ``MSE(clip, base) - alpha * mean(mask)``. Plain SGD,
    then l clamped to <= LP_LOW and h to >= LP_HIGH. Every batch of
    ``dataset`` moves to the clip parameters' device, where the whole
    loop runs. Returns (learned params, loss history).
    """
    device = clip_params["l"].device
    history = []
    for _ in range(epochs):
        for batch in dataset:
            batch = batch.to(device)
            y_base = apply_base(batch)
            cp = {k: v.detach().requires_grad_(True)
                  for k, v in clip_params.items()}
            y, mask_mean = apply_clip(cp, batch)
            mse = torch.mean((y - y_base) ** 2)
            loss = mse - alpha * mask_mean
            grads = torch.autograd.grad(loss, [cp["l"], cp["h"]])
            with torch.no_grad():
                clip_params = {
                    "l": torch.clamp_max(cp["l"] - lr * grads[0],
                                         float(LP_LOW)),
                    "h": torch.clamp_min(cp["h"] - lr * grads[1],
                                         float(LP_HIGH))}
            history.append({"loss": loss.item(), "mse": mse.item(),
                            "mask": mask_mean.item()})
    return clip_params, history


def enhanced_sparsity(x_int8: torch.Tensor, col_mask: torch.Tensor, l: int,
                      h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(natural sparsity, post-clipping sparsity) of an activation tensor."""
    return (subprecision_sparsity(x_int8),
            subprecision_sparsity(apply_clipping(x_int8, col_mask, l, h)))

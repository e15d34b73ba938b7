"""Mamba-2 SSD (state-space duality) mixer: the chunked prefill form and
the one-token decode step (torch twin of ``repro.models.ssd``).

The recurrence  h_t = h_{t-1} * exp(dt_t A) + dt_t B_t x_t^T,
y_t = C_t h_t + D x_t  is evaluated chunk by chunk (a Python loop over
chunks, JAX's ``lax.scan``): inside a chunk the quadratic
"attention-like" dual form, across chunks the carried state. Every
product runs in f32, as in the reference; the contractions are plain
torch einsums, as they are XLA einsums there (no Pallas kernel computes
SSD).

One numerical repair: the reference forms the intra-chunk decay
``exp(cs_i - cs_j)`` over the whole Q x Q chunk and only then multiplies
by the causal mask. Above the diagonal the exponent is a sum of
``dt * |A|`` (positive), which overflows f32 ``exp`` once it passes ~88,
and ``inf * 0`` is NaN: at a chunk of 128 positions and ``dt`` near its
initial ~0.8 a step the reference's chunked output has NaN rows, where
its own stepwise recurrence is finite. Here the exponent is masked
first, ``exp(where(causal, cs_i - cs_j, -inf))`` (the "segsum" form): in
the lower triangle the same f32 value, above it 0. Every other product
keeps the reference's order, so where the reference is finite the two
agree to f32 rounding, and at every length the chunked form equals the
stepwise one (the reference's own contract).

Shapes: x (B, L, G, Hg, P) with H = G*Hg heads of dim P; B/C (B, L, G, N).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.tp import model_input, reduce_from_model
from repro_torch.models.layers import silu


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, L, CH); w (W, CH); b (CH,). The W
    taps unrolled, summed in f32, then cast to x's dtype."""
    wlen, length = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], wlen - 1, x.shape[2])), x], 1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(wlen):
        out = out + xp[:, i:i + length, :].float() * w[i]
    return (out + b).to(x.dtype)


def conv1d_step(conv_state: torch.Tensor, x_new: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. conv_state (B, W-1, CH); x_new (B, CH). Returns
    (the next conv state, the conv output (B, CH) in x_new's dtype)."""
    window = torch.cat([conv_state, x_new[:, None, :]], 1)
    out = (window.float() * w[None]).sum(1) + b
    return window[:, 1:, :], out.to(x_new.dtype)


def ssd_chunked(x: torch.Tensor,        # (B, L, G, Hg, P)
                dt: torch.Tensor,       # (B, L, G, Hg), post-softplus
                a_log: torch.Tensor,    # (G, Hg): A = -exp(a_log)
                b_in: torch.Tensor,     # (B, L, G, N)
                c_in: torch.Tensor,     # (B, L, G, N)
                d_skip: torch.Tensor,   # (G, Hg)
                chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, G, Hg, P) in x's dtype, the final state
    (B, G, Hg, P, N) f32). A length the chunk does not divide is
    tail-padded with dt = 0 there: identity updates."""
    bsz, length, g, hg, p = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, length)
    pad = (-length) % chunk
    if pad:
        x, dt, b_in, c_in = (torch.cat([t, t.new_zeros(
            (bsz, pad) + tuple(t.shape[2:]))], 1)
            for t in (x, dt, b_in, c_in))
    A = -torch.exp(a_log.float())                       # (G, Hg), negative
    iq = torch.arange(chunk, device=x.device)
    causal = iq[:, None] >= iq[None, :]
    h = (torch.zeros((bsz, g, hg, p, n), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    ys = []
    for c0 in range(0, length + pad, chunk):
        rows = slice(c0, c0 + chunk)
        xq, dtq = x[:, rows].float(), dt[:, rows].float()
        bq, cq = b_in[:, rows].float(), c_in[:, rows].float()
        aq = dtq * A                                    # (B, Q, G, Hg)
        cs = torch.cumsum(aq, 1)                        # decay from chunk start
        total = cs[:, -1]                               # (B, G, Hg)

        # intra-chunk dual (quadratic) form, the exponent masked first
        scores = torch.einsum("bign,bjgn->bgij", cq, bq)   # (B, G, Q, Q)
        cs_t = cs.permute(0, 2, 3, 1)                      # (B, G, Hg, Q)
        seg = cs_t[..., :, None] - cs_t[..., None, :]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        m = scores[:, :, None] * decay
        m = m * dtq.permute(0, 2, 3, 1)[..., None, :]      # fold dt_j
        y_intra = torch.einsum("bghij,bjghp->bighp", m, xq)

        # contribution of the carried state
        y_inter = torch.einsum("bign,bghpn->bighp", cq, h)
        y_inter = y_inter * torch.exp(cs)[..., None]

        # state update
        w_j = torch.exp(total[:, None] - cs) * dtq         # (B, Q, G, Hg)
        s_new = torch.einsum("bjgh,bjgn,bjghp->bghpn", w_j, bq, xq)
        h = h * torch.exp(total)[..., None, None] + s_new

        y = y_intra + y_inter + xq * d_skip[None, None, :, :, None]
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1)[:, :length], h


def ssd_decode_step(h: torch.Tensor,        # (B, G, Hg, P, N)
                    x: torch.Tensor,        # (B, G, Hg, P)
                    dt: torch.Tensor,       # (B, G, Hg)
                    a_log: torch.Tensor,    # (G, Hg)
                    b_in: torch.Tensor,     # (B, G, N)
                    c_in: torch.Tensor,     # (B, G, N)
                    d_skip: torch.Tensor    # (G, Hg)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update. Returns (y (B, G, Hg, P) in x's dtype, the
    new state f32)."""
    A = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf * A)                             # (B, G, Hg)
    upd = torch.einsum("bgh,bgn,bghp->bghpn", dtf, b_in.float(), xf)
    h_new = h * da[..., None, None] + upd
    y = torch.einsum("bgn,bghpn->bghp", c_in.float(), h_new)
    y = y + xf * d_skip[None, :, :, None]
    return y.to(x.dtype), h_new


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) op by op:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-6, ways: int = 1) -> torch.Tensor:
    """Mamba-2's output gate, norm(y * silu(z)) with the zero-centred
    gain ``(1 + gamma)``, in f32, cast back to y's dtype. ``ways`` > 1:
    a mesh train step's shard holds 1/ways of the channels (its heads),
    so the mean of squares is the model group's sum of each rank's sum,
    over the global width: reduced in the forward pass and, through
    copy-to-model, in the backward pass, where each rank's share of the
    variance's grad is the whole grad."""
    dt = y.dtype
    yz = y.float() * silu(z.float())
    if ways == 1:
        var = (yz * yz).mean(dim=-1, keepdim=True)
    else:
        ss = model_input(reduce_from_model((yz * yz).sum(-1, keepdim=True)))
        var = ss / (yz.shape[-1] * ways)
    return ((yz * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)

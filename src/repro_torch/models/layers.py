"""Shared layers of the serving paths (torch twin of
``repro.models.layers``): RMSNorm, LayerNorm, SiLU and the tanh GELU
(both rounded op by op as JAX rounds them), RoPE, embedding, the
inter-layer activation wire telemetry, and the float attention of the
fixed-batch path and of training (``flash_attention`` over a whole
sequence, causal or bidirectional,
``decode_attention`` over a dequantized cache — plain torch, as they are
plain jnp in JAX)."""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

from repro_torch.core.packing import dense_bytes_rows, measured_wire_bytes_rows
from repro_torch.core.quantize import quantize_activations
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.kernels.ref import decode_attention_f32

NEG_INF = -2.0e38


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """f32 RMSNorm with a zero-centred gain: ``x * rsqrt(var) * (1 + g)``."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 LayerNorm, cast back to x's dtype:
    ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    dt = x.dtype
    x = x.float()
    d = x - x.mean(dim=-1, keepdim=True)
    var = (d * d).mean(dim=-1, keepdim=True)
    return (d * torch.rsqrt(var + eps) * gamma + beta).to(dt)


def _exactly(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (a Python float that dtype holds)."""
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


# jax.nn.gelu(approximate=True)'s constants as JAX casts them to x's
# dtype, made once here: a Python number that the dtype holds exactly
# multiplies a tensor of it as that dtype's product does (one rounding of
# the exact f32 product), and needs no host-to-device copy inside a
# CUDA-graph capture
_GELU_CONSTANTS = {dt: (_exactly((2 / math.pi) ** 0.5, dt),
                        _exactly(0.044715, dt))
                   for dt in (torch.float32, torch.bfloat16)}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op by op, each op rounded to x's
    dtype as JAX rounds it (``F.gelu(approximate="tanh")`` rounds once
    and differs at bf16)."""
    c, a = _GELU_CONSTANTS[x.dtype]
    inner = c * (x + a * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s steps on the last axis (a true division by the
    sum)."""
    un = torch.exp(x - x.amax(-1, keepdim=True))
    return un / un.sum(-1, keepdim=True)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op, each op rounded to x's dtype (at bf16
    torch.sigmoid rounds once and differs from JAX in ~1/3 of
    elements)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotate the two HALVES of the last dim (not interleaved pairs).
    x (..., S, H, hd) with positions (..., S), or (B, H, hd) with (B,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def act_wire_telemetry(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row int8 MSB4 sparsity, measured packed-wire bytes and dense
    int8 bytes of a hidden activation tensor (..., D)."""
    q = quantize_activations(x, bits=8, per_token=True).q
    return {
        "sparsity": subprecision_sparsity(q, axis=-1),
        "wire_bytes": measured_wire_bytes_rows(q).float(),
        "dense_bytes": torch.full(q.shape[:-1], float(dense_bytes_rows(q)),
                                  dtype=torch.float32, device=q.device),
    }


def stack_sublayer_telemetry(tels: List[Dict[str, torch.Tensor]]
                             ) -> Dict[str, torch.Tensor]:
    """Stack per-sub-layer telemetry dicts into per-key (L, ...) tensors."""
    return {k: torch.stack([t[k] for t in tels], 0) for k in tels[0]}


class AttnSpec(NamedTuple):
    causal: bool = True
    window: int = 0          # 0 = unlimited; sliding window otherwise
    prefix_len: int = 0      # positions < prefix_len attend bidirectionally


def _mask(qi: torch.Tensor, kj: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(len(qi), len(kj)) boolean allow-mask from absolute positions: all
    keys for a bidirectional (encoder) spec; under ``causal`` keys <= the
    query and a bidirectional prefix (keys < ``prefix_len`` seen by every
    query); a sliding window (``qi - kj < window``) in both."""
    qi, kj = qi[:, None], kj[None, :]
    allow = torch.ones(torch.broadcast_shapes(qi.shape, kj.shape),
                       dtype=torch.bool, device=qi.device)
    if spec.causal:
        causal_ok = kj <= qi
        if spec.prefix_len:
            causal_ok = causal_ok | (kj < spec.prefix_len)
        allow = allow & causal_ok
    if spec.window:
        allow = allow & ((qi - kj) < spec.window)
    return allow


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    spec: AttnSpec, *, bq: int = 512,
                    bkv: int = 1024) -> torch.Tensor:
    """Blockwise f32 online-softmax attention, q (B, Sq, H, hd) over k/v
    (B, Skv, KVH, hd), GQA groups of H/KVH heads; output in q's dtype.
    The block loop is JAX's: ``bq``/``bkv`` are cut to the sequence and
    must divide it."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    hdv = v.shape[-1]
    g = h // kvh
    bq, bkv = min(bq, sq), min(bkv, skv)
    if sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) do not divide ({sq}, {skv})")
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd).float()
    kf, vf = k.float(), v.float()
    outs = []
    for iq in range(sq // bq):
        qb = qg[:, iq * bq:(iq + 1) * bq]
        qpos = iq * bq + torch.arange(bq, device=q.device)
        m = torch.full((b, kvh, g, bq), NEG_INF, device=q.device)
        den = torch.zeros((b, kvh, g, bq), device=q.device)
        acc = torch.zeros((b, kvh, g, bq, hdv), device=q.device)
        for jk in range(skv // bkv):
            kb = kf[:, jk * bkv:(jk + 1) * bkv]
            vb = vf[:, jk * bkv:(jk + 1) * bkv]
            kpos = jk * bkv + torch.arange(bkv, device=q.device)
            s = torch.einsum("bihgd,bjhd->bhgij", qb, kb) * scale
            s = torch.where(_mask(qpos, kpos, spec)[None, None, None], s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgij,bjhd->bhgid",
                                                       p, vb)
            m = m_new
        out = acc / torch.clamp_min(den, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hdv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     spec: AttnSpec) -> torch.Tensor:
    """One new token per sequence: q (B, H, hd) over a dequantized cache
    (B, Smax, KVH, hd), positions <= pos (B,) and, with a window, > pos -
    window; f32 softmax, output in q's dtype. The plain version of the
    contiguous KV4 decode kernel."""
    b, h, hd = q.shape
    kvh = k_cache.shape[2]
    out = decode_attention_f32(q.reshape(b, kvh, h // kvh, hd),
                               k_cache.float(), v_cache.float(), pos,
                               spec.window)
    return out.reshape(b, h, v_cache.shape[-1])

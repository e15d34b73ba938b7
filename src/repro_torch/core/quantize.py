"""Integer quantization substrate: W4A8 weights, int8 activations, KV4.

Torch twin of ``repro.core.quantize``. Every quantity is computed in the
input's dtype exactly as the JAX package does it (``amax / 127`` and
``x / scale`` stay in bf16 for a bf16 activation), and ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """q * scale + zero  ≈  original  (zero is in real units)."""

    q: torch.Tensor          # int8 container
    scale: torch.Tensor      # f32, broadcastable to q
    zero: torch.Tensor       # f32, broadcastable to q (0.0 when symmetric)
    bits: int

    @property
    def shape(self):
        return tuple(self.q.shape)

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale + self.zero


def _qrange(bits: int) -> tuple[int, int]:
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


@functools.lru_cache(maxsize=None)
def _constant(value: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d`` rounded once, in x's dtype. On a CUDA tensor torch turns
    a division by a Python number into a multiply by its reciprocal,
    which rounds differently from JAX's division (and the CPU's); a
    divisor tensor on x's device keeps the true division."""
    return x / _constant(d, x.dtype, x.device)


def quantize_weights(w: torch.Tensor, bits: int = 4,
                     axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel quantization; ``axis`` is the reduction axis."""
    lo, hi = _qrange(bits)
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(_div(amax, hi), 1e-8)
    q = torch.clamp(torch.round(w / scale), lo, hi).to(torch.int8)
    scale = scale.float()
    return QuantizedTensor(q=q, scale=scale, zero=torch.zeros_like(scale),
                           bits=bits)


def quantize_activations(
    x: torch.Tensor,
    bits: int = 8,
    per_token: bool = True,
    zero_point: bool = False,
    amax: Optional[torch.Tensor] = None,
) -> QuantizedTensor:
    """Int8 activation quantization, per token (last axis) or per tensor.

    ``zero_point`` shifts the distribution so its minimum lands at q = 0
    (the paper's §3.1 adjustment); ``amax`` overrides the abs-max.
    """
    lo, hi = _qrange(bits)
    dims = (x.ndim - 1,) if per_token else tuple(range(x.ndim))
    if zero_point:
        if amax is not None:
            raise ValueError("amax override not supported with zero_point")
        xmin = x.amin(dim=dims, keepdim=True)
        xmax = x.amax(dim=dims, keepdim=True)
        scale = torch.clamp_min(_div(xmax - xmin, hi), 1e-8)
        q = torch.clamp(torch.round((x - xmin) / scale), 0, hi).to(torch.int8)
        return QuantizedTensor(q=q, scale=scale.float(), zero=xmin.float(),
                               bits=bits)
    if amax is None:
        amax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(_div(amax, hi), 1e-8)
    q = torch.clamp(torch.round(x / scale), lo, hi).to(torch.int8)
    scale = scale.float()
    return QuantizedTensor(q=q, scale=scale, zero=torch.zeros_like(scale),
                           bits=bits)


def activation_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The per-token scale of :func:`quantize_activations` alone, in the
    activation's dtype (the fused encoder divides by it)."""
    return scale_from_amax(x.abs().amax(dim=-1, keepdim=True), bits)


def scale_from_amax(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """:func:`activation_scale` of rows whose abs-max is ``amax`` (the
    row-parallel linear's all-reduced amax), in amax's dtype."""
    _, hi = _qrange(bits)
    return torch.clamp_min(_div(amax, hi), 1e-8)


def quantize_kv(kv: torch.Tensor, bits: int = 4) -> QuantizedTensor:
    """KV-cache quantization (per head-dim-channel scales), KV4 in the
    paper."""
    return quantize_weights(kv, bits=bits, axis=-1)


def dequantize(t: QuantizedTensor) -> torch.Tensor:
    return t.dequantize()


def fake_quantize(x: torch.Tensor, bits: int = 8,
                  per_token: bool = True) -> torch.Tensor:
    """Quantize-dequantize in one op."""
    return quantize_activations(x, bits=bits,
                                per_token=per_token).dequantize()

"""The full SPARQLe linear on a quantized weight, zero-point adjustment
included (torch twin of ``repro.core.sparse_matmul``
``quantized_linear_sparqle``).

quantize (per token; with ``zero_point`` the row's minimum shifted to
q = 0, the paper's §3.1 adjustment) -> clip -> split -> dual pass, through
the kernel wrappers: the scale-taking encoder (row 1 on the card) and
the dual-pass matmul (row 3), or their plain versions on CPU tensors.
The reference's XLA dual pass (``sparqle_matmul_xla``) has its
counterpart in ``kernels/ref.py`` ``sparqle_matmul_ref``, which the
matmul wrapper runs on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qlinear import pack_int4
from repro_torch.core.quantize import QuantizedTensor, quantize_activations
from repro_torch.kernels.sparqle_encode import sparqle_encode
from repro_torch.kernels.sparqle_matmul import sparqle_matmul


def quantized_linear_sparqle(
    x: torch.Tensor,
    w: QuantizedTensor,
    *,
    col_mask: Optional[torch.Tensor] = None,
    clip_l=None,
    clip_h=None,
    zero_point: bool = False,
) -> torch.Tensor:
    """x (..., K) @ w (``w.q`` (K, N) int4 values in int8) -> f32
    (..., N). With ``zero_point``, x = q * scale + zero per token, so
    x @ W = (q * scale) @ W + zero * colsum(W): the dual pass on the
    shifted q and the zero times the dequantized weight's column sums."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1]).contiguous()
    qa = quantize_activations(x2, bits=8, per_token=True,
                              zero_point=zero_point)
    # the encoder quantizes round(x / scale) itself: with a zero point it
    # is given x - zero (in x's dtype, as quantize_activations forms it),
    # whose quotient lies in [0, 127]
    xin = (x2 - qa.zero.to(x2.dtype)) if zero_point else x2
    clip = col_mask is not None and clip_l is not None
    lsb, msb, _, pop = sparqle_encode(
        xin, qa.scale, col_mask if clip else None,
        int(clip_l) if clip else 0, int(clip_h) if clip else 0,
        with_pbm=False)
    n = w.q.shape[-1]
    out = sparqle_matmul(lsb, msb, pop, pack_int4(w.q.to(torch.int8)),
                         qa.scale, w.scale.reshape(1, n).float())
    if zero_point:
        w_colsum = (w.q.float() * w.scale).sum(dim=0)
        out = out + qa.zero.reshape(-1, 1) * w_colsum.reshape(1, -1)
    return out.reshape(*orig[:-1], n)

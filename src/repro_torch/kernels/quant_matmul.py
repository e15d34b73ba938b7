"""Dense single-pass W4A8 matmul: the paper's baseline accelerator.

Replaces the Pallas kernel ``repro/kernels/quant_matmul.py``
``quant_matmul`` (``_kernel``) with the entry ``quant_matmul_launch`` of
``csrc/sparqle_matmul.cu``: the dual-pass kernel's one-plane, ungated
instance (its LSB4-only draft instance) run on the clipped int8 q, one
int8 x int4 pass into an int32 accumulator drained as ``acc.f32 *
act_scale * w_scale`` in the JAX order. So the dense projection gets the
dual pass's weight stream (TMA ring, int8 ``mma.sync``, the weight read
once per 64 rows) and its exact split-K meet, one launch a call with no
zero fill and no drain kernel. It takes the ``pack_int4`` weight the
served tree holds (the Pallas kernel takes int8 ``w``), so a dense and a
SPARQLe projection read the same bytes. Since q = 16 * msb4 + lsb4
exactly, its accumulator equals ``sparqle_matmul``'s on the planes of
the same q, bit for bit.

The shared body restricts K to ``sparqle_matmul.MAX_K`` (65,536): the
kernel sums 16 x the product in int32, exact for full-range q up to K =
131,071. The Pallas kernel has no such limit; no model in the zoo comes
near it.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.quant_matmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import plain_for, quant_matmul_ref
from repro_torch.kernels.sparqle_matmul import (_BDRAFT, _DRAFT, _launch_args,
                                                _operands, _result)

KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "quant_matmul_launch", _DRAFT,
    name="quant_matmul"))
BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "quant_matmul_batched_launch", _BDRAFT,
    name="quant_matmul_batched"))


def _fake(q: torch.Tensor, w_packed: torch.Tensor, act_scale: torch.Tensor,
          w_scale: torch.Tensor, acc_out: bool) -> torch.Tensor:
    return _result(q, w_packed, q.shape[-2], acc_out)


def _plain(q: torch.Tensor, w_packed: torch.Tensor, act_scale: torch.Tensor,
           w_scale: torch.Tensor, acc_out: bool) -> torch.Tensor:
    return plain_for(quant_matmul_ref, w_packed.ndim == 3)(
        q, w_packed, act_scale, w_scale, acc_out=acc_out)


@_build.kernel_op("quant_matmul", _fake, _plain)
def QUANT_MATMUL_OP(q: torch.Tensor, w_packed: torch.Tensor,
                    act_scale: torch.Tensor, w_scale: torch.Tensor,
                    acc_out: bool) -> torch.Tensor:
    """The dense entry: operands checked by the wrapper."""
    res, tail = _launch_args(q, w_packed, act_scale, w_scale, q.shape[-2],
                             acc_out)
    if tail is not None:
        (KERNEL if w_packed.ndim == 2 else BATCHED_KERNEL).launch(
            q.data_ptr(), w_packed.data_ptr(), *tail)
    return res


def quant_matmul(
    q: torch.Tensor,                    # (M, K) int8
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    *,
    acc_out: bool = False,
) -> torch.Tensor:
    """(M, N) f32 ``acc * act_scale * w_scale``, or the int32 ``acc``;
    with a leading expert axis on every operand (q (E, M, K), w_packed
    (E, K/2, N), ...) the batched instance's one launch computes all E.
    Raises for a CUDA tensor with K > ``MAX_K``."""
    if not _build.on_card(q):
        return plain_for(quant_matmul_ref, w_packed.ndim == 3)(
            q, w_packed, act_scale, w_scale, acc_out=acc_out)
    m, k = q.shape[-2:]
    if k != 2 * w_packed.shape[-2]:
        raise ValueError(f"K mismatch: activation {tuple(q.shape)}, packed "
                         f"weight {tuple(w_packed.shape)}")
    _operands(q, None, None, w_packed, act_scale, w_scale, (m, k),
              msb_skip=True, plane="q")
    return QUANT_MATMUL_OP(q, w_packed, act_scale, w_scale, acc_out)

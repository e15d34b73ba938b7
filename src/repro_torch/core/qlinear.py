"""SPARQLe quantized linear — torch twin of ``repro.core.qlinear``.

``SparqleLinear`` holds a deployed projection: the int4 weight packed two
per byte along K, per-output-channel scales, the offline importance mask
and the clipping constants. :func:`linear` is the single projection entry
point of the model code; on a ``SparqleLinear`` in ``sparqle`` mode it
runs

    fused encode (per-token scale, quantize, clip, split, tile
    populations, one launch) -> dual-pass matmul on the packed weight

through the kernel wrappers, which launch the Hopper kernels for CUDA
tensors and run their plain versions for CPU tensors. The result equals
the JAX package's ``_quantized_apply`` bit for bit: the same int8
planes, the same int32 accumulator, the same ``acc * act_scale *
w_scale`` drain. Inside :func:`msb_skip_scope` every such projection
runs the LSB4-only draft matmul instead (the draft forward of
self-speculative decoding). A projection with ``wire_format="packed"``
runs the same chain on the packed wire format (``core.packing``): the
packed encoder and the packed dual-pass (or draft) matmul; the codec is
exact, so its accumulator equals the unpacked one bit for bit, as in
JAX's ``_dual_pass_matmul(wire_format="packed")``.
:func:`expert_linear` runs the same chain on a routed MoE projection,
x (E, C, K) against the (E, K/2, N) expert weights with a clip mask per
expert: one batched encoder launch and one batched matmul launch for
all E experts, as JAX's ``_quantized_apply(batched=True)``.

``tp="row"`` marks a row-parallel call site (``distributed/tp.py``).
Under an active TP context the input features and the weight's K are
this rank's slices: the linear all-reduces (MAX) the local row amax over
the model group, forms the global per-token scale from it, encodes with
the entries that take a scale, runs the matmul with its int32
accumulator out, all-reduces (SUM) that accumulator once and drains
``(acc * act_scale) * w_scale`` in f32 as the kernel's epilogue does,
then adds the bias. Outside a TP context the mark is inert: no launch
is added and no bit moves. Under a mesh train step (``TPContext.train``)
a float row-parallel site sums its partial output through
``distributed.tp.reduce_from_model`` (an all-reduce autograd can
differentiate) instead of the in-place all-reduce of serving.

The clipping constants ``l``/``h`` stay on the CPU whatever the device of
the weights: they are read on the host at every call (kernel arguments),
and a device scalar would synchronise the stream each time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.clipping import importance_mask_tile_aligned
from repro_torch.core.quantize import (QuantizedTensor, quantize_weights,
                                       scale_from_amax)
from repro_torch.distributed.tp import reduce_from_model, tp_ctx
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.sparqle_encode import (sparqle_encode,
                                                sparqle_encode_fused,
                                                sparqle_encode_packed,
                                                sparqle_encode_packed_fused,
                                                sparqle_quantize,
                                                sparqle_quantize_fused)
from repro_torch.kernels.sparqle_matmul import (sparqle_matmul,
                                                sparqle_matmul_packed)

WIRE_FORMATS = ("unpacked", "packed")


# Draft-mode flag (self-speculative decoding): while True, every sparqle
# projection runs LSB4-only — the MSB pass is not launched at all. It is
# read at each eager call; a compiled step reads it at its capture, as a
# JAX trace does (the draft step sets it itself).
_MSB_SKIP = False


@contextlib.contextmanager
def msb_skip_scope(enabled: bool = True):
    """Run every sparqle projection in LSB4-only (draft) mode."""
    global _MSB_SKIP
    prev = _MSB_SKIP
    _MSB_SKIP = enabled
    try:
        yield
    finally:
        _MSB_SKIP = prev


def msb_skip_active() -> bool:
    return _MSB_SKIP


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack two's-complement int4 values two per byte along ``axis``:
    byte j holds element 2j in its low and 2j+1 in its high nibble."""
    if q.shape[axis] % 2:
        raise ValueError(f"odd length {q.shape[axis]} on axis {axis}")
    t = q.movedim(axis, -1)
    lo, hi = t[..., 0::2], t[..., 1::2]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.to(torch.int8).movedim(-1, axis).contiguous()


def unpack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extending)."""
    t = q.movedim(axis, -1)
    lo = (t << 4) >> 4
    hi = t >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(*t.shape[:-1],
                                                t.shape[-1] * 2)
    return out.movedim(-1, axis).contiguous()


@dataclasses.dataclass
class SparqleLinear:
    """A quantized projection in SPARQLe served form.

    ``w.q`` is (K/2, N) when ``packed`` (else (K, N): w_bits > 4 or odd
    K, which the matmul kernel does not take), (E, K/2, N) for routed
    experts, or layer-stacked with a leading (L,) axis; ``col_mask``
    (K,) or (E, K) bool or None; ``l``/``h`` CPU f32 scalars (or (L,)
    when stacked). ``wire_format`` 'packed' routes
    the activations of a sparqle-mode projection through the packed
    wire format (dense mode ignores it, as in JAX).
    """

    w: QuantizedTensor
    col_mask: Optional[torch.Tensor]
    l: Optional[torch.Tensor]
    h: Optional[torch.Tensor]
    mode: str = "sparqle"
    packed: bool = False
    wire_format: str = "unpacked"

    def unpacked_q(self) -> torch.Tensor:
        """The int4 values unpacked along K (int8), any leading axes."""
        return unpack_int4(self.w.q) if self.packed else self.w.q

    def dequantize(self) -> torch.Tensor:
        """The float weight the quantized one stands for, f32: ``q *
        scale + zero`` as JAX's ``SparqleLinear.dequantize`` forms it
        (the absorbed MLA attention's ``wkv_b``)."""
        return self.unpacked_q().float() * self.w.scale + self.w.zero

    def layer(self, i: int) -> "SparqleLinear":
        """The ``i``-th layer of a layer-stacked projection. The host
        constants ``l``/``h`` are split in numpy, so no tensor op is
        dispatched for them: a CUDA-graph capture or a trace of a step
        sees their values only (as the kernels' arguments)."""
        pick = lambda t: None if t is None else t[i]  # noqa: E731
        host = lambda t: None if t is None else torch.from_numpy(  # noqa: E731
            t.numpy()[i:i + 1].reshape(()))
        return dataclasses.replace(
            self, w=QuantizedTensor(self.w.q[i], self.w.scale[i],
                                    self.w.zero[i], self.w.bits),
            col_mask=pick(self.col_mask), l=host(self.l), h=host(self.h))

    def to(self, device) -> "SparqleLinear":
        """Weights and mask to ``device``; ``l``/``h`` stay on the CPU."""
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, w=QuantizedTensor(mv(self.w.q), mv(self.w.scale),
                                    mv(self.w.zero), self.w.bits),
            col_mask=mv(self.col_mask))


@dataclasses.dataclass
class ShardedLinear(SparqleLinear):
    """One rank's compute form of a projection cut over the model axis of
    a serving mesh (``distributed.tp.ServeMesh.compute``): ``cut``
    'col' (the rank's output channels: q, scale and zero cut along N) or
    'row' (the rank's K slice of the packed q and of the mask, scales
    whole); the rank's index ``rank`` of ``ways`` over ``group``. A
    row-cut projection takes the whole input (it slices the rank's K
    itself) or the rank's slice, and runs the row-parallel chain
    (:func:`_row_apply`) whatever the call site's mark."""
    cut: str = "col"
    rank: int = 0
    ways: int = 1
    group: Any = None


def tree_index(tree, i: int):
    """Layer ``i`` of a layer-stacked param subtree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return tree.layer(i)
    return tree[i]


def tree_to(tree, device):
    """Move every tensor / ``SparqleLinear`` of a param tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return tree.to(device)
    return tree.to(device)


def _row_parallel(tp: Optional[str]):
    """The TP context when ``tp`` marks a row-parallel site under an
    active context of more than one model rank, else None."""
    ctx = tp_ctx()
    return ctx if (tp == "row" and ctx is not None and ctx.ways > 1
                   and ctx.serve_mesh is None) else None


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
           tp: Optional[str] = None) -> torch.Tensor:
    """Universal projection: x (..., K) @ w (K, N) [+ b]; ``w`` is a float
    tensor or a :class:`SparqleLinear`. ``tp="row"``: a row-parallel site
    (module docstring); the bias lands on the reduced output."""
    if isinstance(w, SparqleLinear):
        y = _quantized_apply(x, w, tp=tp)
    else:
        ctx = _row_parallel(tp)
        if ctx is not None and ctx.train and x.shape[-1] != w.shape[-2]:
            # the whole input of a row-cut weight (a train step's gathered
            # heads): the rank's K slice of it
            x = x.narrow(-1, ctx.model_rank * w.shape[-2], w.shape[-2])
        y = x @ w.to(x.dtype)
        if ctx is not None and ctx.train:    # autograd: reduce-from-model
            y = reduce_from_model(y)
        elif ctx is not None:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ctx.group)
    if b is not None:
        if isinstance(w, ShardedLinear) and b.shape[-1] != y.shape[-1]:
            b = b.narrow(-1, w.rank * y.shape[-1], y.shape[-1])  # col cut
        y = y + b.to(y.dtype)
    return y


def expert_linear(x: torch.Tensor, w, *,
                  tp: Optional[str] = None) -> torch.Tensor:
    """Batched expert projection: x (E, C, K) @ w (E, K, N). A
    routed-expert :class:`SparqleLinear` (a served tree) runs the batched
    kernels; a float weight (a trained tree) takes :func:`linear`'s float
    branch, one batched product with the weight cast to x's dtype.
    ``tp="row"`` as in :func:`linear`."""
    if not isinstance(w, SparqleLinear):
        return linear(x, w, tp=tp)
    return _quantized_apply(x, w, batched=True, tp=tp)


def _quantized_apply(x: torch.Tensor, sl: SparqleLinear,
                     batched: bool = False,
                     tp: Optional[str] = None) -> torch.Tensor:
    """encode with the per-token scale formed in the same launch
    (quantize, clip, split; packed in the wire format when
    ``sl.wire_format`` says so) -> dual pass (LSB pass alone under
    :func:`msb_skip_scope`) -> rescale by the scale the encoder
    returned, or in dense mode quantize + clip -> single pass ->
    rescale, through the kernel wrappers. ``batched``: x (E, C, K)
    against (E, K/2, N) expert weights, each expert's rows clipped by
    its own mask row and drained by its own scales. A row-parallel site
    under a TP context takes :func:`_row_apply` instead."""
    if sl.mode not in ("sparqle", "dense"):
        raise ValueError(f"mode={sl.mode!r}: expected 'sparqle' or 'dense'")
    if sl.wire_format not in WIRE_FORMATS:
        raise ValueError(f"wire_format={sl.wire_format!r}: expected one of "
                         f"{WIRE_FORMATS}")
    if sl.w.q.ndim != (3 if batched else 2):
        raise ValueError(f"weight {tuple(sl.w.q.shape)}: expected "
                         f"{'(E, K/2, N)' if batched else '(K/2, N)'}")
    if not sl.packed:
        raise NotImplementedError(
            f"unpacked {sl.w.bits}-bit weight: the W4A8 matmuls take only "
            f"int4 weights packed two per byte along K (pack_int4)")
    orig = x.shape
    x2 = (x if batched else x.reshape(-1, orig[-1])).contiguous()
    clip = sl.col_mask is not None and sl.l is not None
    clip_args = (sl.col_mask if clip else None, int(sl.l) if clip else 0,
                 int(sl.h) if clip else 0)
    n = sl.w.q.shape[-1]
    w_scale = sl.w.scale.reshape(*sl.w.q.shape[:-2], 1, n).float()
    ctx = _row_parallel(tp)
    if isinstance(sl, ShardedLinear) and sl.cut == "row":
        k_loc = sl.w.q.shape[-2] * 2
        if x2.shape[-1] == k_loc * sl.ways:     # the whole input
            x2 = x2.narrow(-1, sl.rank * k_loc, k_loc).contiguous()
        elif x2.shape[-1] != k_loc:
            raise ValueError(f"row-cut projection of K {k_loc} a rank: "
                             f"input of {x2.shape[-1]}")
        out = _row_apply(x2, sl, clip_args, w_scale, sl.group)
    elif ctx is not None:
        out = _row_apply(x2, sl, clip_args, w_scale, ctx.group)
    elif sl.mode == "dense":
        q, scale = sparqle_quantize_fused(x2, *clip_args)
        out = quant_matmul(q, sl.w.q, scale, w_scale)
    elif sl.wire_format == "packed":
        lsb, msb, _, pop, scale = sparqle_encode_packed_fused(x2, *clip_args)
        out = sparqle_matmul_packed(lsb, msb, pop, sl.w.q, scale, w_scale,
                                    msb_skip=_MSB_SKIP)
    else:
        lsb, msb, _, pop, scale = sparqle_encode_fused(x2, *clip_args,
                                                       with_pbm=False)
        out = sparqle_matmul(lsb, msb, pop, sl.w.q, scale, w_scale,
                             msb_skip=_MSB_SKIP)
    return out.reshape(*orig[:-1], n).to(x.dtype)


def _row_apply(x2: torch.Tensor, sl: SparqleLinear, clip_args,
               w_scale: torch.Tensor, group) -> torch.Tensor:
    """The row-parallel chain on this rank's K slice: one MAX all-reduce
    of the row amax (in f32, which holds x's dtype exactly), the global
    scale, the scale-taking encoder, the matmul's int32 accumulator, one
    SUM all-reduce of it, the f32 drain in the kernel epilogue's order."""
    amax = x2.abs().amax(dim=-1, keepdim=True).float()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = scale_from_amax(amax.to(x2.dtype)).float()
    if sl.mode == "dense":
        q = sparqle_quantize(x2, scale, *clip_args)
        acc = quant_matmul(q, sl.w.q, scale, w_scale, acc_out=True)
    elif sl.wire_format == "packed":
        lsb, msb, _, pop = sparqle_encode_packed(x2, scale, *clip_args)
        acc = sparqle_matmul_packed(lsb, msb, pop, sl.w.q, scale, w_scale,
                                    acc_out=True, msb_skip=_MSB_SKIP)
    else:
        lsb, msb, _, pop = sparqle_encode(x2, scale, *clip_args,
                                          with_pbm=False)
        acc = sparqle_matmul(lsb, msb, pop, sl.w.q, scale, w_scale,
                             acc_out=True, msb_skip=_MSB_SKIP)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc.float() * scale * w_scale


# ---------------------------------------------------------------------------
# offline conversion: float param tree -> SPARQLe served tree
# ---------------------------------------------------------------------------

_QUANT_LEAF = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|w_fc|w_proj|w_in|w_out|"
    r"wq_a|wq_b|wkv_a|wkv_b|lm_head|w_shared_gate|w_shared_up|w_shared_down)$")


def is_quantizable(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    return bool(_QUANT_LEAF.search(path.rsplit("/", 1)[-1]))


def is_expert(path: str) -> bool:
    """A routed-expert projection, (E, K, N) a layer: under a ``moe/``
    subtree and not a shared expert's (plain (K, N) despite its place)."""
    return (("/moe/" in path or path.startswith("moe/"))
            and "shared" not in path.rsplit("/", 1)[-1])


def quantize_leaf(
    leaf: torch.Tensor,
    *,
    w_bits: int = 4,
    k_percent: float = 50.0,
    clip_l: float = -8.0,
    clip_h: float = 23.0,
    mode: str = "sparqle",
    tile_k: int = 128,
    enable_clipping: bool = True,
    wire_format: str = "unpacked",
) -> SparqleLinear:
    """Quantize one (K, N) projection, or (E, K, N) routed experts, into
    served form; the int4 payload is packed two per byte along K unless
    w_bits > 4 or K is odd.
    ``wire_format='packed'`` serves its activations in the packed wire
    format."""
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"wire_format={wire_format!r}: expected one of "
                         f"{WIRE_FORMATS}")
    if leaf.ndim not in (2, 3):
        raise ValueError(f"unsupported weight rank {leaf.ndim}")
    wq = quantize_weights(leaf, bits=w_bits, axis=-2)
    mask = None
    if enable_clipping:   # one mask an expert for (E, K, N)
        mask = (importance_mask_tile_aligned(leaf, k_percent, tile_k)
                if leaf.ndim == 2 else torch.stack([
                    importance_mask_tile_aligned(w, k_percent, tile_k)
                    for w in leaf]))
    do_pack = w_bits <= 4 and wq.q.shape[-2] % 2 == 0
    if do_pack:
        wq = QuantizedTensor(q=pack_int4(wq.q), scale=wq.scale, zero=wq.zero,
                             bits=wq.bits)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return SparqleLinear(
        w=wq, col_mask=mask,
        l=f32(clip_l) if enable_clipping else None,
        h=f32(clip_h) if enable_clipping else None,
        mode=mode, packed=do_pack, wire_format=wire_format)


def _join(sls, op, host: bool) -> SparqleLinear:
    """``SparqleLinear``s joined by ``op`` (``torch.cat`` or
    ``torch.stack``): weights and masks, and with ``host`` the clip
    constants ``l``/``h`` too (else the first's are kept)."""
    j = lambda ts: None if ts[0] is None else op(ts)  # noqa: E731
    first = sls[0]
    clips = dict(l=j([s.l for s in sls]), h=j([s.h for s in sls])) \
        if host else {}
    return dataclasses.replace(
        first,
        w=QuantizedTensor(j([s.w.q for s in sls]),
                          j([s.w.scale for s in sls]),
                          j([s.w.zero for s in sls]), first.w.bits),
        col_mask=j([s.col_mask for s in sls]), **clips)


def concat_experts(sls) -> SparqleLinear:
    """Join routed-expert ``SparqleLinear``s quantized a chunk of experts
    at a time, (E_i, K/2, N) each, along the expert axis: the whole
    leaf's, since the scales (over K) and the masks are per expert."""
    return sls[0] if len(sls) == 1 else _join(sls, torch.cat, host=False)


def stack_linears(sls) -> SparqleLinear:
    """Stack per-layer ``SparqleLinear``s along a new leading (L,) axis."""
    return _join(sls, torch.stack, host=True)


def quantize_model_params(
    params: Dict[str, Any],
    *,
    w_bits: int = 4,
    k_percent: float = 50.0,
    clip_l: float = -8.0,
    clip_h: float = 23.0,
    mode: str = "sparqle",
    enable_clipping: bool = True,
    tile_k: int = 128,
    wire_format: str = "unpacked",
    device=None,
) -> Dict[str, Any]:
    """Rewrite every projection leaf of a param tree into SPARQLe form;
    layer-stacked leaves quantize one layer at a time. With ``device``
    every leaf moves there first, a projection one layer at a time, so a
    host tree (a restored checkpoint) is quantized on the card without a
    whole float copy of it there. Routed-expert leaves (under ``moe/``,
    not ``w_shared_*``) are (E, K, N) a layer: (L, E, K, N) stacked,
    (E, K, N) without the layer axis.
    ``wire_format='packed'`` serves every projection's activations in
    the packed wire format."""

    def q1(w):
        return quantize_leaf(w.to(device or w.device), w_bits=w_bits,
                             k_percent=k_percent, clip_l=clip_l,
                             clip_h=clip_h, mode=mode,
                             enable_clipping=enable_clipping, tile_k=tile_k,
                             wire_format=wire_format)

    def walk(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif is_quantizable(path, v):
                if v.ndim == 2 or (v.ndim == 3 and is_expert(path)):
                    out[k] = q1(v)
                elif v.ndim in (3, 4):
                    out[k] = stack_linears([q1(v[i])
                                            for i in range(v.shape[0])])
                else:
                    raise ValueError(f"{path}: rank {v.ndim}")
            else:
                out[k] = v.to(device or v.device)
        return out

    return walk(params)

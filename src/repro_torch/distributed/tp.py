"""Tensor-parallel serving over ``torch.distributed`` (torch twin of
``repro.distributed.tp``).

The serving steps become SPMD programs: one process per rank of a
``("data", "model")`` mesh (``launch/mesh.py``) runs the exact
single-device step bodies on its shard, with

  * weights partitioned on ``"model"`` in the Megatron column/row
    pattern (:func:`shard_params`): column-parallel projections keep an
    untouched slice of the output channels, row-parallel ones a slice of
    K (the packed int4 rows, the importance mask's columns) with their
    per-output-channel scales replicated; norms, the embedding table and
    the MoE router replicate; routed and shared experts shard on their
    hidden dim, never on the expert axis;
  * the paged pool sharded on ``kv_heads`` over ``"model"`` and on
    ``pages`` over ``"data"`` (``distributed/sharding.py``), each data
    rank owning a slice of the decode slots.

Bit-exactness (greedy streams equal the single-device engine's): a
row-parallel SPARQLe linear (``core/qlinear.py`` with ``tp="row"``)

  1. takes its per-token scale from the GLOBAL row: an all-reduce MAX of
     the local row maxima over the model group (max is exact in any
     order), so every rank's int8 planes are slices of the unsharded
     planes;
  2. encodes with that scale and runs the dual pass with the int32
     accumulator out (LSB and shifted MSB partials already merged);
  3. reduces that accumulator with ONE int32 all-reduce SUM (integer
     addition is associative), then drains ``(acc * act_scale) *
     w_scale`` in f32 as the kernel's epilogue does.

Column-parallel linears are exact by construction. :func:`tp_scope`
installs the context a step body runs under; outside it the ``tp="row"``
marks of the model code are inert and the single-device path is
unchanged, launch for launch.

Training (``TPContext.train``) runs the same model code on float shards
under autograd, so its collectives are ``torch.autograd.Function``s
(Megatron's f and g): :func:`model_input` (copy-to-model: identity
forward, the grad all-reduced over model in backward) at the input of a
column-parallel block, :func:`reduce_from_model` (all-reduce forward in
f32, identity backward) at a row-parallel output,
:func:`gather_from_model` (the vocab shards all-gathered, own slice of
the grad back) at the untied head, and :func:`gather_rows` (the
microbatch's rows all-gathered over data, own rows of the grad back)
before a replicated MoE's routing. The backward pass (and a remat
layer's recompute) must run inside the scope too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantizedTensor

# ---------------------------------------------------------------------------
# the step-time TP context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPContext:
    """What a step body needs of the mesh. ``group`` reduces over the
    model axis (``ways`` ranks). ``batch_group`` is set when the step's
    batch is sharded over the data axis (decode, draft, verify; not the
    replicated prefill): ``batch_ways`` ranks, this one ``batch_rank``,
    each holding ``local_rows`` rows of the global batch. ``train``: a
    mesh train step (module docstring) at model rank ``model_rank``, on
    data rank ``data_rank`` of ``data_ways`` (``data_group``), each
    holding its rows of every microbatch."""
    ways: int = 1
    group: Any = None
    batch_group: Any = None
    batch_ways: int = 1
    batch_rank: int = 0
    local_rows: int = 0
    train: bool = False
    model_rank: int = 0
    data_group: Any = None
    data_ways: int = 1
    data_rank: int = 0


_TP: Optional[TPContext] = None


@contextlib.contextmanager
def tp_scope(ctx: Optional[TPContext]) -> Iterator[None]:
    """Run the enclosed step body under ``ctx`` (None: single device)."""
    global _TP
    prev = _TP
    active = ctx is not None and (ctx.ways > 1 or ctx.batch_group is not None
                                  or ctx.train)
    _TP = ctx if active else None
    try:
        yield
    finally:
        _TP = prev


def tp_ctx() -> Optional[TPContext]:
    return _TP


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the grad all-reduced (SUM) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (SUM, in f32) forward, cast back; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.float().contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the grad."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Copy-to-``group``: identity forward, grad all-reduced backward."""
    return _CopyTo.apply(x, group)


def reduce_from(y: torch.Tensor, group) -> torch.Tensor:
    """Reduce-from-``group``: f32 SUM all-reduce forward, identity
    backward."""
    return _ReduceFrom.apply(y, group)


def _train_model_ctx() -> Optional[TPContext]:
    ctx = _TP
    return ctx if ctx is not None and ctx.train and ctx.ways > 1 else None


def model_input(x: torch.Tensor) -> torch.Tensor:
    """x entering a column-parallel block (or a leaf replicated over model
    used on model-sharded activations) under a train step of model
    ways > 1: copy-to-model. ``x`` itself otherwise."""
    ctx = _train_model_ctx()
    return x if ctx is None else copy_to(x, ctx.group)


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel partial output summed over model (train step)."""
    ctx = _train_model_ctx()
    return y if ctx is None else reduce_from(y, ctx.group)


def gather_from_model(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' shards of ``y`` along ``dim`` (train step)."""
    ctx = _train_model_ctx()
    return y if ctx is None else _GatherFrom.apply(y, ctx.group,
                                                   dim % y.ndim)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of ``t`` (dim 0) in data-rank order under a
    train step of data ways > 1; this rank's rows of the grad back."""
    ctx = _TP
    if ctx is None or not ctx.train or ctx.data_ways == 1:
        return t
    return _GatherFrom.apply(t, ctx.data_group, 0)


# ---------------------------------------------------------------------------
# per-shard model config
# ---------------------------------------------------------------------------

def validate_tp_config(cfg: ModelConfig, ways: int) -> None:
    """Raise listing every dimension the model axis cannot divide. The
    row-parallel FFN weights are packed two int4 values a byte along K,
    so each shard's K slice must hold whole bytes: d_ff % (2 ways). An
    SSD mixer (``ssm_state`` set) is cut by heads, ``d_inner /
    ssm_head_dim``; its B/C groups either divide too (a rank takes whole
    groups with their heads) or are one group, whole on every rank."""
    if ways <= 1:
        return
    problems: List[str] = []
    if cfg.n_heads % ways:
        problems.append(f"n_heads={cfg.n_heads} % model={ways}")
    if cfg.n_kv_heads % ways:
        problems.append(f"n_kv_heads={cfg.n_kv_heads} % model={ways}")
    if cfg.ssm_state:
        nh = cfg.d_inner // cfg.ssm_head_dim
        if nh % ways:
            problems.append(f"SSD heads d_inner/ssm_head_dim={nh} % "
                            f"model={ways}")
        if cfg.ssm_groups != 1 and cfg.ssm_groups % ways:
            problems.append(f"ssm_groups={cfg.ssm_groups} % model={ways} "
                            f"(and not 1)")
    if cfg.d_ff and cfg.d_ff % (2 * ways):
        problems.append(f"d_ff={cfg.d_ff} % 2*model={2 * ways}")
    if cfg.moe_d_ff and cfg.moe_d_ff % (2 * ways):
        problems.append(f"moe_d_ff={cfg.moe_d_ff} % 2*model={2 * ways}")
    if not cfg.tie_embeddings and cfg.vocab % ways:
        problems.append(f"vocab={cfg.vocab} % model={ways}")
    if problems:
        raise ValueError(
            f"config {cfg.name!r} cannot shard {ways}-way on the model "
            f"axis: " + ", ".join(problems))


def shard_model_config(cfg: ModelConfig, ways: int) -> ModelConfig:
    """The config a shard's step body runs: head counts divided by the
    model ways, ``head_dim`` pinned so ``cfg.hd`` keeps its global value;
    every other field as it is (shapes follow the sharded params: an SSD
    mixer reads its shard's widths from them, ``models/model.py``
    ``_ssd_dims``)."""
    if ways <= 1:
        return cfg
    validate_tp_config(cfg, ways)
    return cfg.replace(n_heads=cfg.n_heads // ways,
                       n_kv_heads=cfg.n_kv_heads // ways, head_dim=cfg.hd)


# ---------------------------------------------------------------------------
# the partition table and the weight shards
# ---------------------------------------------------------------------------

# projection leaves by Megatron role (keys of the param tree)
_COL_KEYS = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "w_fc",
                       "lm_head", "w_shared_gate", "w_shared_up"})
_ROW_KEYS = frozenset({"wo", "w_down", "w_proj", "w_shared_down"})
_COL_BIAS_KEYS = frozenset({"bq", "bk", "bv", "b_fc"})


def slice_for_rank(t: Optional[torch.Tensor], dim: int, rank: int,
                   ways: int) -> Optional[torch.Tensor]:
    """Rank ``rank``'s contiguous 1/``ways`` slice of ``t`` along ``dim``."""
    if t is None:
        return None
    n = t.shape[dim]
    if n % ways:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"{ways} ways")
    step = n // ways
    return t.narrow(dim, rank * step, step).contiguous()


def shard_linear(sl, kind: str, rank: int, ways: int):
    """col: the output channels of q, scale and zero; row: the packed K
    rows of q and the mask's K columns, scales replicated."""
    w = sl.w
    if kind == "col":
        w = QuantizedTensor(slice_for_rank(w.q, -1, rank, ways),
                            slice_for_rank(w.scale, -1, rank, ways),
                            slice_for_rank(w.zero, -1, rank, ways), w.bits)
        return dataclasses.replace(sl, w=w)
    w = QuantizedTensor(slice_for_rank(w.q, -2, rank, ways), w.scale,
                        w.zero, w.bits)
    return dataclasses.replace(
        sl, w=w, col_mask=slice_for_rank(sl.col_mask, -1, rank, ways))


def shard_params(tree: Dict[str, Any], rank: int, ways: int
                 ) -> Dict[str, Any]:
    """Model-axis rank ``rank``'s slice of a served (or float) param tree
    (layer-stacked and expert leaves included: the cut dims count from
    the end). ``ways == 1`` returns the tree itself."""
    # core.qlinear reads this module's context: imported here, not above
    from repro_torch.core.qlinear import SparqleLinear
    if ways <= 1:
        return tree

    def leaf(key: str, v):
        kind = ("col" if key in _COL_KEYS else
                "row" if key in _ROW_KEYS else None)
        if isinstance(v, SparqleLinear):
            return v if kind is None else shard_linear(v, kind, rank, ways)
        if v is None:
            return None
        if kind == "col" or key in _COL_BIAS_KEYS:
            return slice_for_rank(v, -1, rank, ways)
        if kind == "row":
            return slice_for_rank(v, -2, rank, ways)
        return v

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in t.items()}

    return walk(tree)

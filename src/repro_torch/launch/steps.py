"""The step functions (torch twin of ``repro.launch.steps``), as plain
closures over the config: the train step (``make_train_step``: the loss
with its chunked CE, remat, the MoE aux loss and the MTP term,
microbatched gradient accumulation, optional int8 gradient compression,
AdamW), the engine's prefill, decode (full or LSB4-only draft) and
speculative verify window, and the fixed-batch path's whole-prompt
prefill and decode over contiguous caches
(``make_serve_prefill``/``make_serve_decode``).

The train step runs eagerly, on the float tree: no hand-written kernel
lies on it (the reference trains through XLA's ``dot_general``, flash
attention and MoE dispatch too).

``make_train_step(..., mesh=)`` trains on a ("data", "model") mesh, one
process a rank (the reference's jit under ``mesh_context``). The state
is sharded by ``distributed/sharding.train_placements`` (f32 masters and
both moments over data, FSDP; the Megatron cut over model, routed experts
on the expert axis; :class:`TrainMesh`). Once a step each rank casts its
slices to the compute dtype (MoE subtrees stay f32, as
:func:`cast_params_for_compute` keeps them) and all-gathers them over
data; every microbatch reuses that copy. Each data rank runs the
microbatches on its rows of each (``data.pipeline.data_rows``) under the
train TP context (``distributed/tp.py``: the model code's collectives as
autograd functions); each leaf's f32 grad is summed over data and cut to
the rank's data slice as the backward pass produces it (a microbatch's
grads are never held whole over data), the microbatches' sums added,
then divided by n and by D; a leaf whole over model takes model rank
0's grad (its grad is the same sum on every model rank, but the card's
atomics may order it otherwise), as do the runs of a segmented leaf held
whole (an SSD mixer's B/C columns), so replicated leaves stay bit-equal
across ranks. The loss and metrics are all-reduced over the world, equal
on every rank.

``make_serve_prefill``/``make_serve_decode`` take ``mesh=`` (a
``distributed.tp.ServeMesh``, :func:`serve_mesh`): the fixed-batch steps
as one rank of a (pod, data, model) mesh runs them (``models/model.py``);
:func:`serve_param_schema`, :func:`train_state_schema` and
:func:`batch_specs` give the dry-run (``launch/dryrun.py``) its trees'
and inputs' placements.

The decode step takes a (B, Pmax) tier table too when the KV2 precision
ladder is armed. All keep the JAX steps' static shapes — a (1, C) prefill
chunk whose start and valid count are (1,) device tensors, a (B,) decode
batch and a (B, T) verify window over a (B, Pmax) block table, inactive
slots on the null page — and read no device value on the host, so the
engines and the fixed-batch decode run them as CUDA graphs
(``launch/graphs.py``), one capture per shape. All update the pool in
place and return it (the JAX steps return a new one).

With a ``mesh`` (a ("data", "model") ``DeviceMesh``, ``launch/mesh.py``)
the engine steps run this rank's shard as SPMD, as the JAX package's
``shard_map`` of the same bodies: on a per-shard config (head counts
divided by the model ways) under the TP context of ``distributed/tp``.
The prefill chunk is replicated over data: it takes a (D, Pmax) table,
one row a data shard, the owner's holding the sequence's shard-local
pages and every other row all-null, so a non-owner computes into its
null page; the owner's logits and telemetry reach every rank through a
SUM all-reduce over the data group of values masked to zero elsewhere
(exact: one nonzero term). Decode, draft and verify take this data
rank's slice of the slots and return the whole batch's logits and
telemetry (``models/model.py`` gathers the rows), so every rank samples
the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (REPLICATED, Placement,
                                              TrainShards, train_placements)
from repro_torch.distributed.tp import (TPContext, copy_to, heads_divide,
                                        shard_model_config, slice_for_rank,
                                        tp_scope)
from repro_torch.launch.mesh import MeshLayout, mesh_layout
from repro_torch.models import model as M
from repro_torch.models.schema_builder import build_schema
from repro_torch.optim.adamw import (OptConfig, OptState, adamw_update,
                                     compress_grads, decompress_grads,
                                     init_opt_state)


# ---------------------------------------------------------------------------
# training: the loss, the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    microbatch: int = 0          # 0 = no accumulation (whole batch at once)
    remat: bool = True
    ce_chunk: int = 512          # sequence chunk for the chunked CE
    mtp_weight: float = 0.3
    aux_weight: float = 0.01
    compress_pod_grads: bool = False


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32. logits (..., V), targets (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def chunked_ce(cfg: ModelConfig, params, hidden: torch.Tensor,
               targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """CE over the vocab head without materializing (B, S, V) logits.

    The head and CE of each sequence chunk run under
    ``torch.utils.checkpoint``, recomputed in the backward pass, so the
    peak logits are (B, chunk, V) in f32, as JAX's ``jax.checkpoint``
    inside its scan gives. A sequence the chunk does not divide is
    tail-padded with target -1, which counts nothing."""
    b, s, _ = hidden.shape
    if tuple(targets.shape) != (b, s):
        raise ValueError(f"targets {tuple(targets.shape)} for hidden "
                         f"{tuple(hidden.shape)}")
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)

    def one(h, t):
        logits = M.head_logits(cfg, params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp_min(t, 0).long()[..., None])[..., 0]
        valid = (t >= 0).float()
        return torch.sum((lse - gold) * valid), torch.sum(valid)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        loss, n = torch.utils.checkpoint.checkpoint(
            one, hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
            use_reentrant=False)
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def cast_params_for_compute(cfg: ModelConfig, params):
    """The f32 leaves cast to the compute dtype once, before any use, as
    JAX's (its FSDP gathers then move bf16); autograd takes the grads
    back to the f32 masters through the cast. MoE expert subtrees stay
    f32, as the reference keeps them (a workaround of its CPU backend,
    kept here so both packages compute the same function)."""
    dt = cfg.cdtype

    def walk(tree, in_moe=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_moe or k == "moe")
            elif not in_moe and v.dtype == torch.float32:
                out[k] = v.to(dt)
            else:
                out[k] = v
        return out

    return walk(params)


def loss_fn(cfg: ModelConfig, knobs: TrainKnobs, params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): the chunked CE (a VLM's over its text positions),
    plus ``aux_weight`` x the MoE load-balance loss and, with an MTP head,
    ``mtp_weight`` x its CE (position i predicts tokens[i+2] =
    targets[i+1])."""
    params = cast_params_for_compute(cfg, params)
    hidden, aux = M.forward_hidden(cfg, params, batch, remat=knobs.remat,
                                   with_aux=True)
    targets = batch["targets"]
    if cfg.family == "vlm":      # targets cover only the text positions
        hidden_t = hidden[:, cfg.n_prefix:cfg.n_prefix + targets.shape[1]]
    else:
        hidden_t = hidden
    ce = chunked_ce(cfg, params, hidden_t, targets, knobs.ce_chunk)
    loss = ce + knobs.aux_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        mtp_ce = _xent(M.mtp_logits(cfg, params, hidden, batch),
                       targets[:, 1:])
        loss = loss + knobs.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


def make_accum_grads(cfg: ModelConfig, knobs: TrainKnobs = TrainKnobs()):
    """Returns ``accum_grads(params, batch) -> (loss, metrics, grads)``,
    the gradient half of the train step: the grads of the f32 master
    params by autograd, summed over microbatches of ``knobs.microbatch``
    rows in the reference's order (each leaf's ``.grad`` takes the first
    microbatch's grad and adds the next ones in place: 0 + g1 + g2 ...,
    then / n, the count as a 0-d tensor). A leaf the loss does not reach
    (an encoder's token table) gets a zero grad, as ``jax.grad`` gives."""

    def accum_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in store.flatten(params)]
        tracked = store.unflatten(params, leaves)
        mb = knobs.microbatch
        b = batch["targets"].shape[0]
        if not mb or mb >= b:
            loss, metrics = loss_fn(cfg, knobs, tracked, batch)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            if b % mb:
                raise ValueError(f"batch {b} is not a multiple of the "
                                 f"microbatch {mb}")
            n = b // mb
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(n):
                ub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, _ = loss_fn(cfg, knobs, tracked, ub)
                loss_i.backward()
                lsum = lsum + loss_i.detach()
            nt = torch.tensor(float(n), device=lsum.device)
            for leaf in leaves:
                if leaf.grad is not None:
                    leaf.grad.div_(nt)
            loss = lsum / nt
            metrics = {"ce": loss}
        grads = [leaf.grad if leaf.grad is not None
                 else torch.zeros_like(leaf) for leaf in leaves]
        return loss.detach(), metrics, store.unflatten(params, grads)

    return accum_grads


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    knobs: TrainKnobs = TrainKnobs(), *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``:
    :func:`make_accum_grads`'s grads, int8-quantized and dequantized with
    ``compress_pod_grads`` as the reference's step does, then
    :func:`adamw_update`, which writes the new params and moments in
    place: the state passed in is the state returned (the JAX step
    donates it). The metrics are 0-d device tensors; the step reads
    nothing to the host. With a ``mesh`` (a ("data", "model")
    ``DeviceMesh`` or a :class:`TrainMesh`) the state and the batch are
    this rank's (module docstring): :func:`make_sharded_grads`, the
    compression's scales from each leaf's global amax, the norm over the
    world."""
    if mesh is None:
        accum_grads, counted = make_accum_grads(cfg, knobs), None
    else:
        tm = mesh if isinstance(mesh, TrainMesh) else TrainMesh(cfg, mesh)
        accum_grads, counted = make_sharded_grads(cfg, knobs, tm), \
            tm.counted()

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = accum_grads(state.params, batch)
        if knobs.compress_pod_grads:
            # int8 EF compression of the cross-pod gradient reduction,
            # quantized and dequantized in the step as the reference does
            q, _err = compress_grads(grads, global_amax=counted is not None)
            grads = decompress_grads(q)
        new_params, opt, om = adamw_update(state.params, grads, state.opt,
                                           ocfg, counted)
        metrics = dict(metrics, loss=loss, **om)
        return TrainState(new_params, opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# training on a ("data", "model") mesh
# ---------------------------------------------------------------------------

# leaves whole over model that a train step uses on model-sharded
# activations: column biases (cut to the rank's columns), the qk norms'
# gains (the rank's heads; not MLA's ``q_norm``, the norm of the q LoRA's
# rank, which runs before the copy to model) and an SSD mixer's per-head
# leaves (cut to the rank's heads: ``a_log``/``d_skip`` (.., G, H/G) to
# its heads' (groups, heads a group)); all enter through copy-to-model
_COL_BIAS_KEYS = frozenset({"bq", "bk", "bv", "b_fc"})
_HEAD_GAIN_KEYS = frozenset({"q_norm", "k_norm"})
_SSD_HEAD_KEYS = frozenset({"a_log", "d_skip", "dt_bias", "gn"})


class TrainMesh:
    """A rank's mesh-training view: its :class:`MeshLayout`, the per-shard
    config (the whole config where ``gather_heads`` lets the model ways
    leave the heads undivided: every model rank then attends every head,
    ``distributed/tp.py`` ``gather_heads``), and the :class:`TrainShards`
    of the param tree (the moments
    share the params' placements, the step is replicated). Also what the
    restartable loop needs of a mesh (``distributed/fault.py``): the
    whole state gathered onto rank 0, a whole state cut to this rank,
    agreement on a flag, a barrier."""

    def __init__(self, cfg: ModelConfig, mesh, gather_heads: bool = False,
                 rules=None):
        lay = mesh if isinstance(mesh, MeshLayout) else mesh_layout(mesh)
        M.check_train_mesh(cfg, lay.model_ways, gather_heads)
        self.cfg, self.layout = cfg, lay
        # heads the model ways do not divide: every model rank attends
        # every head (``distributed/tp.py`` ``gather_heads``)
        self.lcfg = (shard_model_config(cfg, lay.model_ways,
                                        heads_only=gather_heads)
                     if heads_divide(cfg, lay.model_ways) else cfg)
        self.schema = build_schema(cfg)
        self.shards = TrainShards(
            train_placements(self.schema, lay.data_ways, lay.model_ways,
                             rules=rules),
            lay.coords, lay.data_group, lay.model_group)

    @property
    def rank(self) -> int:
        c = self.layout.coords
        return c.data_rank * c.model_ways + c.model_rank

    def context(self) -> TPContext:
        c = self.layout.coords
        return TPContext(ways=c.model_ways, group=self.layout.model_group,
                         train=True, model_rank=c.model_rank,
                         data_group=self.layout.data_group,
                         data_ways=c.data_ways, data_rank=c.data_rank)

    def counted(self):
        """Per param leaf: whether this rank counts it in the norm."""
        return [self.shards.counts_norm(pl)
                for pl in store.flatten(self.shards.placements)]

    def placements(self, tree):
        """The placements of a sharded state (the moments share the
        params', the step is whole) or of a param tree."""
        pls = self.shards.placements
        if isinstance(tree, TrainState):
            return TrainState(pls, OptState(step=REPLICATED, mu=pls, nu=pls))
        return pls

    def build_state(self, ocfg: OptConfig, seed: int, device) -> TrainState:
        """This rank's slice of ``launch.train.build_state`` (the params
        drawn leaf by leaf, the one-device bits) and zeroed moments."""
        params = self.shards.init_params(self.schema, seed, device)
        return TrainState(params, init_opt_state(params, ocfg))

    def gather(self, tree):
        """A sharded state (or param tree) whole on rank 0, on the CPU;
        None on the other ranks."""
        return self.shards.gather_root(tree, self.placements(tree))

    def whole_like(self, tree):
        """Meta tensors of the whole tree a sharded ``tree`` cuts."""
        pls = store.flatten(self.placements(tree))
        c = self.layout.coords

        def whole(t, pl: Placement):
            shape = list(t.shape)
            if pl.data_dim is not None:
                shape[pl.data_dim] *= c.data_ways
            if pl.segments is not None:
                shape[pl.model_dim] = sum(n for n, _ in pl.segments)
            elif pl.model_dim is not None:
                shape[pl.model_dim] *= c.model_ways
            return torch.empty(shape, dtype=t.dtype, device="meta")

        return store.unflatten(tree, [whole(t, pl) for t, pl in
                                      zip(store.flatten(tree), pls)])

    def local(self, whole, like):
        """This rank's cut of a whole tree, on the devices of ``like``'s
        leaves (a sharded tree of the same structure)."""
        return store.place_like(
            self.shards.local(whole, self.placements(like)), like)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        if self.layout.backend == "nccl":
            t = t.cuda()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier()


def _world_mean(t: torch.Tensor, world: int) -> torch.Tensor:
    t = t.detach().float().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t / torch.tensor(float(world), device=t.device)


def make_sharded_grads(cfg: ModelConfig, knobs: TrainKnobs, tm: TrainMesh):
    """Returns ``grads(params, batch) -> (loss, metrics, grads)`` on a
    rank's sharded params and its rows of the batch (module docstring):
    the grads are this rank's slices, f32: each microbatch's summed over
    data, those sums added in the one-device order (first + next ...),
    then / n and / D; the loss and metrics the world's means. The
    forward and backward passes run under the train TP context."""
    coords, lay, sh = tm.layout.coords, tm.layout, tm.shards
    world = coords.data_ways * coords.model_ways
    dt = cfg.cdtype
    model_root = tm.rank - coords.model_rank     # model rank 0 of this row

    def wrap(path: str, t: torch.Tensor, pl: Placement,
             mla: bool) -> torch.Tensor:
        key = path.rsplit("/", 1)[-1]
        if coords.model_ways == 1 or pl.model_dim is not None:
            return t
        mine = (coords.model_rank, coords.model_ways)
        if key in _COL_BIAS_KEYS:
            return slice_for_rank(copy_to(t, lay.model_group), -1, *mine)
        if key in _HEAD_GAIN_KEYS and not mla:
            return copy_to(t, lay.model_group)
        if key in _SSD_HEAD_KEYS:
            t = copy_to(t, lay.model_group)
            if key in ("a_log", "d_skip"):       # (.., G, H/G): by head
                heads = slice_for_rank(t.flatten(-2), -1, *mine)
                g = t.shape[-2]
                g = g // coords.model_ways if g % coords.model_ways == 0 \
                    else g
                return heads.unflatten(-1, (g, -1))
            return slice_for_rank(t, -1, *mine)
        return t

    def sharded_grads(params, batch):
        paths = store.leaf_paths(params)
        pls = store.flatten(sh.placements)
        known = set(paths)
        mla = [f"{p.rsplit('/', 1)[0]}/wq_a" in known for p in paths]
        compute = []
        with torch.no_grad():
            for path, t, pl in zip(paths, store.flatten(params), pls):
                if "/moe/" not in f"/{path}" and t.dtype == torch.float32:
                    t = t.to(dt)
                compute.append(sh.gather_data(t, pl))
        b = batch["targets"].shape[0]
        mb = knobs.microbatch // coords.data_ways if knobs.microbatch else 0
        n = b // mb if mb and mb < b else 1
        if n > 1 and b % mb:
            raise ValueError(f"{b} local rows, local microbatch {mb}")
        acc = [None] * len(compute)
        lsum = None

        def accumulate(j):
            # as soon as the backward pass has a leaf's grad: summed over
            # data, cut to this rank's data slice and added into its f32
            # sum; so no rank holds more than one leaf's grad whole over
            # data (every rank's backward meets the leaves in one order)
            def hook(t):
                g = t.grad.float()
                t.grad = None
                if coords.data_ways > 1:
                    dist.all_reduce(g, op=dist.ReduceOp.SUM,
                                    group=lay.data_group)
                    if pls[j].data_dim is not None:
                        g = slice_for_rank(g, pls[j].data_dim,
                                           coords.data_rank,
                                           coords.data_ways).clone()
                acc[j] = g if acc[j] is None else acc[j].add_(g)
            return hook

        with tp_scope(tm.context()):
            for i in range(n):
                ub = (batch if n == 1 else
                      {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
                tracked = [c.detach().requires_grad_() for c in compute]
                for j, t in enumerate(tracked):
                    t.register_post_accumulate_grad_hook(accumulate(j))
                tree = store.unflatten(params, [
                    wrap(*leaf) for leaf in zip(paths, tracked, pls, mla)])
                loss_i, metrics = loss_fn(tm.lcfg, knobs, tree, ub)
                loss_i.backward()
                lsum = loss_i.detach() if lsum is None else \
                    lsum + loss_i.detach()
                del tracked, tree, loss_i
        del compute
        if n > 1:
            nt = torch.tensor(float(n), device=lsum.device)
            acc = [a.div_(nt) if a is not None else None for a in acc]
            loss, metrics = lsum / nt, {"ce": lsum / nt}
        else:
            loss, metrics = lsum, {k: v.detach() for k, v in metrics.items()}
        dways = torch.tensor(float(coords.data_ways), device=lsum.device)
        grads = []
        for a, p, pl in zip(acc, store.flatten(params), pls):
            g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if a is None else a.div_(dways))
            if coords.model_ways > 1 and pl.model_dim is None:
                dist.broadcast(g, src=model_root, group=lay.model_group)
            for lo, w in sh.runs(pl, cut=False):    # B/C runs whole over model
                run = g.narrow(pl.model_dim, lo, w).contiguous()
                dist.broadcast(run, src=model_root, group=lay.model_group)
                g.narrow(pl.model_dim, lo, w).copy_(run)
            grads.append(g)
        loss = _world_mean(loss, world)
        metrics = {k: _world_mean(v, world) for k, v in metrics.items()}
        return loss, metrics, store.unflatten(params, grads)

    return sharded_grads


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_param_schema(cfg: ModelConfig, mode: str = "sparqle"):
    """The served tree's schema: every projection a SparqleLinear of
    ParamSpecs (``models/qschema.py``)."""
    from repro_torch.models.qschema import build_quantized_schema
    return build_quantized_schema(build_schema(cfg), w_bits=cfg.w_bits,
                                  mode=mode)


def _opt_schema(schema):
    """ParamSpec tree of an AdamW moment mirroring the param schema
    (bf16, as the reference's)."""
    from repro_torch.models.schema import ParamSpec
    if isinstance(schema, dict):
        return {k: _opt_schema(v) for k, v in schema.items()}
    return ParamSpec(schema.shape, schema.axes, torch.bfloat16, init="zeros")


def train_state_schema(cfg: ModelConfig) -> TrainState:
    """ParamSpec tree of the whole train state (f32 params, the step,
    bf16 moments): the reference's."""
    from repro_torch.models.schema import ParamSpec
    pschema = build_schema(cfg)
    return TrainState(params=pschema, opt=OptState(
        step=ParamSpec((), (), torch.int32, init="zeros"),
        mu=_opt_schema(pschema), nu=_opt_schema(pschema)))


def batch_specs(batch: Dict[str, torch.Tensor], mesh_shape: Dict[str, int],
                rules=None) -> Dict[str, Tuple]:
    """The ``spec_for`` entries of every input: its dim 0 over the batch
    axes, the rest whole (the reference's ``batch_shardings``)."""
    from repro_torch.distributed.sharding import spec_for
    return {k: spec_for(("batch",) + (None,) * (v.ndim - 1), v.shape,
                        mesh_shape, rules) for k, v in batch.items()}


def serve_mesh(cfg: ModelConfig, mesh_shape: Dict[str, int],
               coords: Dict[str, int], groups: Dict[Tuple[str, ...], Any],
               *, global_batch: int, max_len: int, kind: str = "decode",
               profile: str = "baseline", rules=None):
    """The ``ServeMesh`` of a ``--legacy`` step of ``kind`` ('prefill' or
    'decode') on a mesh of ``mesh_shape``: the served tree's and the
    caches' placements under the profile's rules (``distributed/
    sharding.py`` ``profile_rules``; or under ``rules``, a whole table),
    the batch's entry."""
    from repro_torch.distributed.sharding import (merged_rules,
                                                  profile_rules, spec_for)
    from repro_torch.distributed.tp import ServeMesh
    from repro_torch.models.qschema import tree_specs
    from repro_torch.models.registry import cache_schema
    if rules is None:
        rules = merged_rules(profile_rules(profile, cfg, kind, mesh_shape,
                                           global_batch))
    cspecs: Dict[str, Tuple] = {}

    def flat(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v)
            else:
                cspecs[k] = tuple(v[1:])     # the layer dim dropped

    flat(tree_specs(cache_schema(cfg, global_batch, max_len), mesh_shape,
                    rules))
    batch = spec_for(("batch",), (global_batch,), mesh_shape, rules)
    return ServeMesh(
        mesh_shape=dict(mesh_shape), coords=dict(coords), groups=groups,
        specs=tree_specs(serve_param_schema(cfg), mesh_shape, rules),
        cache_specs=cspecs, batch_entry=batch[0] if batch else None,
        global_batch=global_batch, rules=rules)


def serve_context(sm, local_rows: int = 0) -> TPContext:
    """The step context of a ``ServeMesh`` step: the model group, and the
    batch's group where the batch is cut (``local_rows`` rows a rank: a
    decode's norms run at their global rows, ``models/model.py``
    ``_norm``; 0 for a prefill, whose rows norm alone)."""
    cut = sm.batch_ways > 1
    return TPContext(
        ways=sm.model_ways, group=sm.group("model"),
        batch_group=sm.group(sm.batch_entry) if cut else None,
        batch_ways=sm.batch_ways, batch_rank=sm.index(sm.batch_entry),
        local_rows=local_rows if cut else 0, serve_mesh=sm)


def make_serve_prefill(cfg: ModelConfig, max_len: int, *, mesh=None):
    """(params, batch {"tokens": (B, S)}, and for a VLM "patches"
    (B, n_prefix, D) in front of them; an encoder's "frames" (B, S, D))
    -> (greedy next token (B,) int32, contiguous caches of ``max_len``
    positions). With ``mesh`` (a ``ServeMesh``, :func:`serve_mesh`) the
    step runs this rank's part: ``params`` the rank's tree as placed, the
    batch its rows (all of them where the batch is whole over data), the
    tokens and caches its own."""

    @torch.no_grad()
    def serve_prefill(params, batch):
        ctx = None if mesh is None else serve_context(mesh)
        with tp_scope(ctx):
            logits, cache = M.prefill(cfg, params, batch, max_len=max_len)
        return _greedy(logits), cache

    return serve_prefill


def make_serve_decode(cfg: ModelConfig, *, mesh=None):
    """(params, cache, token (B,), pos (B,)) -> (greedy next token (B,)
    int32, cache updated in place). With ``mesh`` as
    :func:`make_serve_prefill`'s: the rank's rows and cache slices."""

    @torch.no_grad()
    def serve_decode(params, cache, token, pos):
        ctx = None if mesh is None else serve_context(mesh, token.shape[0])
        with tp_scope(ctx):
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
        return _greedy(logits), cache

    return serve_decode


def _mesh_layout(cfg: ModelConfig, mesh):
    """(this rank's MeshLayout, the per-shard config)."""
    lay = mesh_layout(mesh)
    return lay, shard_model_config(cfg, lay.model_ways)


def make_engine_prefill_chunk(cfg: ModelConfig, *, mesh=None):
    """(params, pool, tokens (1, C), start (1,), valid (1,), block_table
    (1, Pmax)) -> (logits (1, V) at the last valid position, pool,
    telemetry); ``start``/``valid`` int32 tensors (or Python ints). With
    a ``mesh`` the table is (D, Pmax), one row a data shard (module
    docstring)."""
    if mesh is None:
        @torch.no_grad()
        def prefill_chunk(params, pool, tokens, start, valid, block_table):
            return M.prefill_chunk_paged(cfg, params, pool, tokens, start,
                                         valid, block_table)

        return prefill_chunk

    lay, lcfg = _mesh_layout(cfg, mesh)
    d = lay.coords.data_rank

    def owner_only(t, mine):
        # f32 holds every value exactly: x + 0 = x
        t32 = torch.where(mine, t.float(), torch.zeros((), device=t.device))
        dist.all_reduce(t32, op=dist.ReduceOp.SUM, group=lay.data_group)
        return t32.to(t.dtype)

    @torch.no_grad()
    def prefill_chunk_sharded(params, pool, tokens, start, valid, tables):
        table = tables[d:d + 1]
        with tp_scope(lay.context()):
            logits, pool, tel = M.prefill_chunk_paged(
                lcfg, params, pool, tokens, start, valid, table)
        if lay.data_ways > 1:
            mine = (table != 0).any()
            logits = owner_only(logits, mine)
            tel = {k: owner_only(v, mine) for k, v in tel.items()}
        return logits, pool, tel

    return prefill_chunk_sharded


def make_engine_decode(cfg: ModelConfig, *, msb_skip: bool = False,
                       with_telemetry: bool = True, kv2: bool = False,
                       mesh=None):
    """(params, pool, token (B,), pos (B,), block_tables (B, Pmax))
    -> (logits (B, V), pool, telemetry). Raw logits come back: sampling
    is per request and lives host-side in the engine.

    ``msb_skip=True`` makes the LSB4-only draft step of the speculative
    engine; ``with_telemetry=False`` drops the wire accounting (the
    telemetry comes back empty) — the draft runs γ times per cycle.
    ``kv2=True`` makes the precision-ladder step: it takes ``tier_tables``
    (B, Pmax) after ``block_tables`` and reads each page from the slab
    its tier id names (the pool must hold the KV2 slab). With a ``mesh``
    token/pos/block_tables are this data rank's slots and the logits and
    telemetry the whole batch's; the ladder runs unsharded only."""
    if mesh is not None:
        if kv2:
            raise NotImplementedError(
                "the KV2 precision ladder is unsharded-only (kv2=True with "
                "a mesh is not wired up)")
        lay, lcfg = _mesh_layout(cfg, mesh)

        @torch.no_grad()
        def engine_decode_sharded(params, pool, token, pos, block_tables):
            with tp_scope(lay.context(local_rows=token.shape[0])):
                return M.decode_step_paged(lcfg, params, pool, token, pos,
                                           block_tables, msb_skip=msb_skip,
                                           with_telemetry=with_telemetry)

        return engine_decode_sharded
    if kv2:
        @torch.no_grad()
        def engine_decode_kv2(params, pool, token, pos, block_tables,
                              tier_tables):
            return M.decode_step_paged(cfg, params, pool, token, pos,
                                       block_tables, tier_tables=tier_tables,
                                       msb_skip=msb_skip,
                                       with_telemetry=with_telemetry)

        return engine_decode_kv2

    @torch.no_grad()
    def engine_decode(params, pool, token, pos, block_tables):
        return M.decode_step_paged(cfg, params, pool, token, pos,
                                   block_tables, msb_skip=msb_skip,
                                   with_telemetry=with_telemetry)

    return engine_decode


def make_engine_verify_window(cfg: ModelConfig, *, mesh=None):
    """(params, pool, tokens (B, T), pos (B,), block_tables (B, Pmax))
    -> (logits (B, T, V), pool, telemetry): one full-precision step
    scores every window position of every decode slot and overwrites the
    draft's K/V (``models.model.verify_window_paged``). With a ``mesh``
    the inputs are this data rank's slots, the outputs the whole
    batch's."""
    if mesh is not None:
        lay, lcfg = _mesh_layout(cfg, mesh)

        @torch.no_grad()
        def engine_verify_sharded(params, pool, tokens, pos, block_tables):
            with tp_scope(lay.context(local_rows=tokens.shape[0])):
                return M.verify_window_paged(lcfg, params, pool, tokens, pos,
                                             block_tables)

        return engine_verify_sharded

    @torch.no_grad()
    def engine_verify(params, pool, tokens, pos, block_tables):
        return M.verify_window_paged(cfg, params, pool, tokens, pos,
                                     block_tables)

    return engine_verify

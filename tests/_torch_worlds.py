"""Rank functions of the tensor-parallel CPU tests (``test_torch_tp.py``,
``test_torch_sharded_engine.py``, ``test_torch_mesh_train.py``,
``test_torch_mesh_train_mla_ssd.py``, ``test_torch_legacy_mesh.py``):
each
runs in every process of a gloo world that
``repro_torch.launch.mesh.spawn_world`` spawns, and imports only the
port, so the ranks start without JAX. The tests compute the
JAX references in the parent and compare."""
from __future__ import annotations

import collections
import contextlib
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.qlinear import expert_linear, linear, msb_skip_scope
from repro_torch.distributed.tp import (all_gather, shard_linear,
                                        slice_for_rank, tp_scope)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh, mesh_layout


@contextlib.contextmanager
def counting_collectives(counts: collections.Counter):
    """Count ``torch.distributed`` all-reduces by (op, dtype) and
    all-gathers while inside."""
    reduce, gather = dist.all_reduce, dist.all_gather

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        counts["all_reduce", str(op).split(".")[-1], str(t.dtype)] += 1
        return reduce(t, op=op, group=group, async_op=async_op)

    def all_gather(parts, t, group=None, async_op=False):
        counts["all_gather", str(t.dtype)] += 1
        return gather(parts, t, group=group, async_op=async_op)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        yield
    finally:
        dist.all_reduce, dist.all_gather = reduce, gather


@contextlib.contextmanager
def collective_bytes(acc: collections.Counter):
    """Sum the payload bytes of ``torch.distributed`` all-reduces (the
    tensor reduced) and all-gathers (the tensors received) while inside,
    by the kind names of the attribution."""
    reduce, gather = dist.all_reduce, dist.all_gather

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        acc["all-reduce"] += t.numel() * t.element_size()
        return reduce(t, op=op, group=group, async_op=async_op)

    def all_gather(parts, t, group=None, async_op=False):
        acc["all-gather"] += sum(p.numel() * p.element_size() for p in parts)
        return gather(parts, t, group=group, async_op=async_op)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        yield
    finally:
        dist.all_reduce, dist.all_gather = reduce, gather


def attribution_world(rank: int, jobs):
    """Each job of a mesh as big as the world ({"id", "mesh", "cfg",
    "params", "prompts", "gen", "gamma", "pool", "sched"}): an attributed
    engine serves the prompts while the bytes passed to
    ``torch.distributed`` are summed over the first call of each step
    kind. Returns {id: {phase: (counted bytes of one call, attributed
    collective bytes of one step, calls a step)}}."""
    from repro_torch.serving import (Engine, SamplingParams, SpecConfig,
                                     SpeculativeEngine)
    world = dist.get_world_size()
    out = {}
    for job in jobs:
        shape = job["mesh"]
        if shape[0] * shape[1] != world:
            continue
        kw = dict(pool_config=job["pool"], sched_config=job["sched"],
                  device="cpu", mesh=make_mesh(*shape))
        if job.get("gamma"):
            eng = SpeculativeEngine(job["cfg"], job["params"],
                                    spec=SpecConfig(gamma=job["gamma"]), **kw)
        else:
            eng = Engine(job["cfg"], job["params"], **kw)
        attr = eng.attribute_steps()
        counted = {}

        def counting(phase, fn):
            def call(*args):
                acc: collections.Counter = collections.Counter()
                with collective_bytes(acc):
                    res = fn(*args)
                counted.setdefault(phase, dict(acc))
                return res
            return call

        for phase, name in (("prefill", "_prefill_fn"),
                            ("decode", "_decode_fn"), ("draft", "_draft_fn"),
                            ("verify", "_verify_fn")):
            if hasattr(eng, name):
                setattr(eng, name, counting(phase, getattr(eng, name)))
        for p in job["prompts"]:
            eng.submit(p, SamplingParams(max_new_tokens=job["gen"]))
        eng.run()
        out[job["id"]] = {
            phase: (counted[phase], attr.cost(phase).coll_bytes,
                    attr.cost(phase).calls_per_step)
            for phase in counted}
    return out


def linear_world(rank: int, cases):
    """Every case of ``cases`` on its mesh: {"id", "mesh" (data, model),
    "fn" ('linear', 'expert' or 'sharded'), "partition", "x", "sl" (a
    served SparqleLinear) or "w" (QuantizedTensor) with "col_mask",
    "clip", "wire_format", "msb_skip"}. Returns {id: (output as numpy,
    collective counts)} of this rank (numpy: a tensor handed back through
    shared memory would outlive its process)."""
    meshes = {}
    out = {}
    for c in cases:
        shape = c["mesh"]
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        lay = mesh_layout(mesh)
        m, ways = lay.coords.model_rank, lay.model_ways
        counts: collections.Counter = collections.Counter()
        with counting_collectives(counts), msb_skip_scope(c["msb_skip"]):
            if c["fn"] == "sharded":
                y = ops.sparqle_linear_sharded(
                    c["x"], c["w"], mesh=mesh, partition=c["partition"],
                    col_mask=c["col_mask"], clip_l=c["clip"][0],
                    clip_h=c["clip"][1], wire_format=c["wire_format"],
                    msb_skip=c["msb_skip"])
            else:
                apply = linear if c["fn"] == "linear" else expert_linear
                sl = shard_linear(c["sl"], c["partition"], m, ways)
                if c["partition"] == "col":
                    y = all_gather(apply(c["x"], sl), lay.model_group,
                                   c["x"].ndim - 1)
                else:
                    with tp_scope(lay.context()):
                        y = apply(slice_for_rank(c["x"], -1, m, ways), sl,
                                  tp="row")
        out[c["id"]] = (to_numpy(y.float()), dict(counts))
    return out


def engine_world(rank: int, jobs):
    """Serve each job of a mesh as big as the world: {"id", "mesh",
    "cfg", "params" (the whole served tree), "prompts", "gen", "gamma",
    "pool", "sched"}. Returns {id: (streams, steps, evictions,
    aggregate)}; also the errors of the mesh-validation probes."""
    from repro_torch.serving import (Engine, SamplingParams, SpecConfig,
                                     SpeculativeEngine)
    world = dist.get_world_size()
    meshes = {}
    out = {}
    for job in jobs:
        shape = job["mesh"]
        if shape[0] * shape[1] != world:
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        kw = dict(pool_config=job["pool"], sched_config=job["sched"],
                  device="cpu", mesh=meshes[shape])
        try:
            if job.get("gamma"):
                eng = SpeculativeEngine(job["cfg"], job["params"],
                                        spec=SpecConfig(gamma=job["gamma"]),
                                        **kw)
            else:
                eng = Engine(job["cfg"], job["params"], **kw)
        except (ValueError, NotImplementedError) as e:
            out[job["id"]] = (type(e).__name__, str(e))
            continue
        hs = [eng.submit(p, SamplingParams(max_new_tokens=job["gen"]))
              for p in job["prompts"]]
        eng.run()
        out[job["id"]] = ([list(h.out_tokens) for h in hs], eng.steps,
                          eng.pool.evictions, eng.aggregate_stats())
    return out


def decode_world(rank: int, cfg, params, state, schema, inputs):
    """One sharded decode step for each mesh shape of ``inputs`` ({shape:
    (token, pos, tables)} of the whole batch, tables in shard-local
    ids) as big as the world, from the whole pool ``state``: returns
    {shape: (logits, telemetry, this rank's pool slice after the step)}
    as numpy."""
    from repro_torch.distributed.sharding import shard_pool_state
    from repro_torch.distributed.tp import shard_params
    from repro_torch.launch import steps as S
    world = dist.get_world_size()
    out = {}
    for shape, batch in inputs.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(*shape)
        lay = mesh_layout(mesh)
        pool = shard_pool_state(state, schema, lay.coords)
        local = shard_params(params, lay.coords.model_rank, lay.model_ways)
        n = batch[0].shape[0] // lay.data_ways
        lo = lay.coords.data_rank * n
        token, pos, tables = (t[lo:lo + n] for t in batch)
        step = S.make_engine_decode(cfg, mesh=mesh)
        logits, pool, tel = step(local, pool, token, pos, tables)
        out[shape] = to_numpy((logits, tel, pool))
    return out


def lockstep_world(rank: int):
    """An engine step whose ranks emitted different tokens must raise on
    every rank (the divergence check), not hang."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.serve import build_served_params
    from repro_torch.serving import Engine
    cfg = ModelConfig(name="tiny", family="transformer", n_layers=1,
                      d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                      d_ff=64, vocab=64, dtype="float32")
    eng = Engine(cfg, build_served_params(cfg, 0, "cpu", tile_k=16),
                 device="cpu", mesh=make_mesh(dist.get_world_size() // 2, 2))
    eng._check_lockstep([(0, 5)])                 # equal: passes
    try:
        eng._check_lockstep([(0, 5 + rank)])
    except RuntimeError as e:
        return str(e)
    return None


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return np.asarray(tree.detach().cpu())


def calls_world(rank: int, calls):
    """Each (rank function, args) of ``calls`` in turn, in one world."""
    return [fn(rank, *args) for fn, args in calls]


def _payload(qtree):
    """The int8 leaves of a ``compress_grads`` tree, in the param tree's
    structure."""
    if "q" in qtree and not isinstance(qtree["q"], dict):
        return qtree["q"]
    return {k: _payload(v) for k, v in qtree.items()}


def _checksum(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _gated_norm_rank(job, lay):
    """The 'gnorm' job of :func:`mesh_train_world`."""
    from repro_torch.distributed.tp import TPContext, copy_to
    from repro_torch.models.ssd import gated_rms_norm
    c = lay.coords
    mine = (c.model_rank, c.model_ways)
    y, z = (slice_for_rank(job[k], -1, *mine).requires_grad_()
            for k in ("y", "z"))
    r = slice_for_rank(job["r"], -1, *mine)
    gn = job["gn"].clone().requires_grad_()
    ctx = TPContext(ways=c.model_ways, group=lay.model_group, train=True,
                    model_rank=c.model_rank)
    with tp_scope(ctx):
        gl = slice_for_rank(copy_to(gn, lay.model_group), -1, *mine)
        out = gated_rms_norm(y, z, gl, job["eps"], ways=c.model_ways)
        (out * r).sum().backward()
    return to_numpy((out, y.grad, z.grad, gn.grad))


def mesh_train_world(rank: int, jobs):
    """Mesh training jobs of a mesh as big as the world, each a dict with
    "id", "mesh" (data, model), "kind" and its inputs (whole trees as CPU
    tensors, batches as numpy):

      * 'ep': ``moe_ffn_dist`` on this data rank's rows of "x" with this
        model rank's experts; loss sum(y * r). Returns the output, the
        grads of the rows, the router and the rank's expert slices.
      * 'step': the sharded grads and one sharded train step from the
        whole "state" on the whole "batch" ("knobs", "ocfg"), the
        compression of the whole "grads" cut to the rank. Returns the
        loss, metrics, the gathered grads, int8 payload and new state,
        and (data rank, [(whole over data too, checksum)]) of the leaves
        whole over model.
      * 'ckpt': from "state", "steps" sharded steps, a mesh checkpoint
        saved under "dir" at the end, one more step; the gathered states
        at the checkpoint and after.
      * 'restore': the newest checkpoint under "dir" restored on this
        mesh, one step; the gathered state after.
      * 'gnorm': the SSD gated norm on this model rank's channels of
        "y" and "z" (its heads), the gain "gn" through copy-to-model and
        the rank's slice, ``ways`` = the model ways, under the train TP
        context; loss sum(out * r). Returns the rank's output and the
        grads of its y and z channels and of the whole gain.

    Each rank returns {id: result}: every rank its 'ep' and 'gnorm'
    results, rank 0 the others (trees through ``store.to_host``), the
    other ranks their checksums only. The checksums cover the leaves
    whole over model and the runs of segmented leaves whole over model
    (an SSD mixer's B/C columns held whole)."""
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import steps as S
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim.adamw import compress_grads
    world = dist.get_world_size()
    out = {}
    for job in jobs:
        shape = job["mesh"]
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(*shape)
        lay = mesh_layout(mesh)
        c = lay.coords
        if job["kind"] == "ep":
            x = slice_for_rank(job["x"], 0, c.data_rank, c.data_ways)
            r = slice_for_rank(job["r"], 0, c.data_rank, c.data_ways)
            x = x.clone().requires_grad_()
            wr = job["w_router"].clone().requires_grad_()
            ws = [slice_for_rank(job[k], 0, c.model_rank, c.model_ways
                                 ).clone().requires_grad_()
                  for k in ("w_gate", "w_up", "w_down")]
            y = moe_lib.moe_ffn_dist(
                x, wr, *ws, top_k=job["top_k"], model_rank=c.model_rank,
                model_ways=c.model_ways, group=lay.model_group,
                capacity_factor=job["cf"])
            (y * r).sum().backward()
            out[job["id"]] = to_numpy((y, x.grad, wr.grad,
                                       tuple(w.grad for w in ws)))
            continue
        if job["kind"] == "gnorm":
            out[job["id"]] = _gated_norm_rank(job, lay)
            continue
        cfg = job["cfg"]
        tm = S.TrainMesh(cfg, mesh)
        state = tm.shards.local(job["state"], tm.placements(job["state"]))
        step = S.make_train_step(cfg, job["ocfg"], job["knobs"], mesh=tm)

        def rows(b):
            return shard_batch(b, "cpu", data_rank=c.data_rank,
                               data_ways=c.data_ways,
                               microbatch=job["knobs"].microbatch)

        if job["kind"] == "step":
            batch = rows(job["batch"])
            loss, metrics, grads = S.make_sharded_grads(
                cfg, job["knobs"], tm)(state.params, batch)
            q, _ = compress_grads(tm.shards.local(job["grads"]),
                                  global_amax=True)
            got = {"loss": float(loss),
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": tm.gather(grads),
                   "payload": tm.gather(_payload(q))}
            state, m = step(state, batch)
            got["step_metrics"] = {k: float(v) for k, v in m.items()}
            got["state"] = tm.gather(state)
            pls = store.flatten(tm.shards.placements)
            whole = []
            for t, pl in zip(store.flatten(state.params), pls):
                runs = ([t] if pl.model_dim is None else
                        [t.narrow(pl.model_dim, lo, n)
                         for lo, n in tm.shards.runs(pl, cut=False)])
                whole += [(pl.data_dim is None, _checksum(r)) for r in runs]
            got["replicated"] = (c.data_rank, whole)
        elif job["kind"] == "ckpt":
            for i in range(job["steps"]):
                state, _ = step(state, rows(job["batches"][i]))
            store.save_sharded(job["dir"], state, job["steps"], tm)
            got = {"at_ckpt": tm.gather(state)}
            state, m = step(state, rows(job["batches"][job["steps"]]))
            got["loss"] = float(m["loss"])
            got["after"] = tm.gather(state)
        else:
            latest = store.latest_step(job["dir"])
            state = store.restore_sharded(job["dir"], latest, state, tm)
            state, m = step(state, rows(job["batches"][latest]))
            got = {"loss": float(m["loss"]), "after": tm.gather(state)}
        if rank == 0:
            out[job["id"]] = {k: (store.to_host(v) if k in (
                "grads", "payload", "state", "at_ckpt", "after") else v)
                for k, v in got.items()}
        else:
            out[job["id"]] = {"replicated": got.get("replicated")}
    return out


def legacy_mesh_world(rank: int, jobs):
    """The ``--legacy`` steps on a (data, model) mesh as big as the world:
    each job a dict with "id", "mesh" (data, model), "cfg", the whole
    served tree "params" (CPU tensors), the whole "batch" (numpy), "gen"
    and "max_len". The rank takes its part of the tree and of the batch
    (``ServeMesh.local``), prefills and decodes "gen" greedy steps under
    the serve contexts, and returns {id: (first row, [greedy tokens a
    step], [logits a step])} for its rows, as numpy."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import mesh_coords, serve_groups
    from repro_torch.models import model as M
    world = dist.get_world_size()
    groups, out = {}, {}
    for job in jobs:
        d, m = job["mesh"]
        if d * m != world:
            continue
        layout = {"data": d, "model": m}
        if (d, m) not in groups:          # every rank, in one order
            groups[(d, m)] = serve_groups(layout)
        cfg, gb = job["cfg"], next(iter(job["batch"].values())).shape[0]
        sms = [S.serve_mesh(cfg, layout, mesh_coords(layout, rank),
                            groups[(d, m)], global_batch=gb,
                            max_len=job["max_len"], kind=k)
               for k in ("prefill", "decode")]
        params = sms[0].local(job["params"], sms[0].specs)
        batch = {k: sms[0].local(torch.from_numpy(v), spec) for (k, v), spec
                 in zip(job["batch"].items(), S.batch_specs(
                     {k: torch.from_numpy(v) for k, v in
                      job["batch"].items()}, layout).values())}
        rows = next(iter(batch.values())).shape[0]
        first = sms[0].index(sms[0].batch_entry) * rows if rows != gb else 0
        t0 = sum(v.shape[1] for k, v in batch.items()
                 if k in ("tokens", "patches", "frames"))
        toks, logits = [], []
        with torch.no_grad():
            with tp_scope(S.serve_context(sms[0])):
                lg, cache = M.prefill(cfg, params, batch,
                                      max_len=job["max_len"])
            for i in range(job["gen"] + 1):
                tok = torch.argmax(lg, -1).to(torch.int32)
                toks.append(tok.numpy())
                logits.append(lg.float().numpy())
                if i == job["gen"] or cfg.family == "encoder":
                    break
                pos = torch.full_like(tok, t0 + i)
                with tp_scope(S.serve_context(sms[1], rows)):
                    lg, cache = M.decode_step(cfg, params, cache, tok, pos)
        out[job["id"]] = (first, toks, logits)
    return out


def gather_heads_world(rank: int, job):
    """One sharded train step (``TrainMesh(gather_heads=True)``: heads the
    model ways do not divide attended whole on every model rank) of a
    world-sized (data, model) mesh, from the whole "state" on the whole
    "batch"; returns the loss and the grads gathered onto rank 0
    (numpy; None elsewhere)."""
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import steps as S
    mesh = make_mesh(*job["mesh"])
    lay = mesh_layout(mesh)
    c = lay.coords
    tm = S.TrainMesh(job["cfg"], mesh, gather_heads=True)
    params = tm.shards.local(job["state"].params)
    batch = shard_batch(job["batch"], "cpu", data_rank=c.data_rank,
                        data_ways=c.data_ways,
                        microbatch=job["knobs"].microbatch)
    loss, _, grads = S.make_sharded_grads(job["cfg"], job["knobs"], tm)(
        params, batch)
    whole = tm.gather(grads)
    return float(loss), None if whole is None else [
        to_numpy(g) for g in store.flatten(whole)]

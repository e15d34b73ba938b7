"""Port parity, mesh training: the train step on a ("data", "model") mesh
of gloo ranks (``launch/steps.py`` with ``mesh=``) against JAX's
single-device step, the expert-parallel MoE against JAX's
``moe_ffn_local_ep``, the train placement against JAX's ``spec_for``,
mesh checkpoints across mesh shapes, and the mesh CLI's restart.

One world of 2 ranks and one of 4 run every job of the module (spawning
costs seconds); the rank functions live in ``tests/_torch_worlds.py``
and import no JAX. JAX runs here, in-process, on one CPU device.

Tolerances (``tests/test_torch_train.py``'s contract): loss within 1e-5
of JAX's, relative; each gathered grad leaf within 1e-4 of that leaf's
max |g|; params within 2 lr of JAX's step. The expert-parallel MoE's
output and grads within 1e-5 of each tensor's max (f32 sums in other
orders). The int8 compression payload, checkpoints and the faulted CLI
run are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import spec_for as jspec_for
from repro.launch import steps as JS
from repro.models.moe import moe_ffn_local_ep
from repro.models.registry import SMOKES as JSMOKES
from repro.models.schema import ParamSpec as JParamSpec
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import adamw_update as jadamw
from repro.optim.adamw import init_opt_state as jinit_opt
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_train_state
from repro_torch.data.pipeline import data_rows
from repro_torch.distributed.sharding import (Placement, spec_for,
                                              train_placements)
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.schema_builder import build_schema
from repro_torch.optim.adamw import OptConfig, compress_grads, tree_leaves

from _torch_worlds import _payload, mesh_train_world

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4       # of the leaf's max |g|
EP_TOL = 1e-5         # of the tensor's max
OCFG = dict(warmup_steps=1, total_steps=4)
LR = 3e-4
B, S_LEN, MB = 4, 16, 2          # two microbatches of 2
ARCHS = ("granite-8b", "starcoder2-3b", "deepseek-moe-16b")
MESHES = {"granite-8b": ((1, 2), (2, 1), (2, 2)),
          "starcoder2-3b": ((1, 2), (2, 1)),
          "deepseek-moe-16b": ((1, 2), (2, 1), (2, 2))}
EP_CASES = (((1, 2), 32), ((2, 2), 64), ((2, 2), 48))  # (mesh, tokens)
CKPT_STEPS = 2


def _jc(arch):
    jc = JSMOKES[arch].replace(dtype="float32")
    if jc.n_experts:     # no drops: local and global routing keep the same
        jc = jc.replace(capacity_factor=jc.n_experts / jc.top_k)
    return jc


def _tc(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)
            for k in ("tokens", "targets")}


def _knobs(mod):
    return mod.TrainKnobs(microbatch=MB, ce_chunk=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _jax_reference(arch):
    """JAX's train step on one batch from seed-0 params, as its
    ``make_train_step`` composes it (jitted in two parts, so the grads can
    be read): the microbatches' ``value_and_grad`` of ``loss_fn`` summed
    in order from zeros, / n; then ``adamw_update``."""
    jc = _jc(arch)
    params = jinit(jschema(jc), jax.random.PRNGKey(0))
    jstate = JS.TrainState(params, jinit_opt(params, JOptConfig(**OCFG)))
    batch = _batch(jc, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(jc, _knobs(JS), p, b)[0]))
    gsum = jax.tree_util.tree_map(jnp.zeros_like, params)
    lsum = 0.0
    for i in range(B // MB):
        loss, g = grad_fn(params, {k: v[i * MB:(i + 1) * MB]
                                   for k, v in jb.items()})
        gsum = jax.tree_util.tree_map(jnp.add, gsum, g)
        lsum = lsum + loss
    n = B // MB
    grads = jax.tree_util.tree_map(lambda g: g / n, gsum)
    new_params, opt, om = jax.jit(lambda p, g, s: jadamw(
        p, g, s, JOptConfig(**OCFG)))(params, grads, jstate.opt)
    return dict(jc=jc, start=_np(jstate), batch=batch,
                new=_np(JS.TrainState(new_params, opt)),
                metrics=dict({k: float(v) for k, v in om.items()},
                             loss=float(lsum / n)),
                grads=_np(grads))


def _ep_case(mesh, t, seed=3):
    """Tokens, router and experts of the deepseek-moe smoke MoE (E 8,
    top 2, d 64, f 32) at its default capacity factor (drops happen)."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def draw(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(id=("ep", mesh, t), mesh=mesh, kind="ep", top_k=cfg.top_k,
                cf=cfg.capacity_factor, x=draw(t, d), r=draw(t, d),
                w_router=draw(d, e, scale=d ** -0.5),
                w_gate=draw(e, d, f, scale=d ** -0.5),
                w_up=draw(e, d, f, scale=d ** -0.5),
                w_down=draw(e, f, d, scale=f ** -0.5))


def _torch_job(job):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in job.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank job of the module: the world of 4 first (it writes the
    2x2 checkpoint), then the world of 2 (which restores it). Returns
    (each job's results by id, a list of its ranks', the JAX references
    by arch, the checkpoint's batches and directory)."""
    refs = {arch: _jax_reference(arch) for arch in ARCHS}
    jobs = [_torch_job(_ep_case(mesh, t)) for mesh, t in EP_CASES]
    for arch in ARCHS:
        ref = refs[arch]
        tc = _tc(ref["jc"])
        state = convert_train_state(ref["start"])
        _, _, grads = TS.make_accum_grads(tc, _knobs(TS))(
            state.params, {k: torch.from_numpy(v)
                           for k, v in ref["batch"].items()})
        ref["grads_1x1"] = grads
        for mesh in MESHES[arch]:
            jobs.append(dict(id=("step", arch, mesh), mesh=mesh,
                             kind="step", cfg=tc, state=state,
                             batch=ref["batch"], grads=grads,
                             ocfg=OptConfig(**OCFG), knobs=_knobs(TS)))
    ck = str(tmp_path_factory.mktemp("mesh_ckpt"))
    moe = refs["deepseek-moe-16b"]
    batches = [_batch(moe["jc"], 10 + i) for i in range(CKPT_STEPS + 1)]
    common = dict(cfg=_tc(moe["jc"]), state=convert_train_state(
        moe["start"]), ocfg=OptConfig(**OCFG), knobs=_knobs(TS),
        batches=batches, dir=ck)
    jobs.append(dict(common, id="ckpt", mesh=(2, 2), kind="ckpt",
                     steps=CKPT_STEPS))
    jobs.append(dict(common, id="restore", mesh=(1, 2), kind="restore"))
    # the reverse: a one-device checkpoint, restored at 2x2
    ck1 = str(tmp_path_factory.mktemp("one_device_ckpt"))
    state = convert_train_state(moe["start"])
    step = TS.make_train_step(common["cfg"], common["ocfg"], common["knobs"])
    for i in range(CKPT_STEPS + 1):
        if i == CKPT_STEPS:
            store.save(ck1, state, CKPT_STEPS)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batches[i].items()})
    one = {"loss": float(m["loss"]), "after": store.to_host(state)}
    jobs.append(dict(common, id="restore_1x1", mesh=(2, 2), kind="restore",
                     dir=ck1))
    got = {"one_device": [one]}
    for world in (4, 2):
        ranks = spawn_world(mesh_train_world, world, jobs, deadline_s=300)
        for jid in ranks[0]:
            got[jid] = [r[jid] for r in ranks]
    return got, refs, batches, ck


# ---------------------------------------------------------------------------
# the expert-parallel MoE vs JAX's moe_ffn_local_ep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,t", EP_CASES)
def test_expert_parallel_moe_matches_jax_local_ep(worlds, mesh, t):
    """Per data shard: JAX's ``moe_ffn_local_ep`` vmapped over the model
    axis (one lane an expert shard; the loss on lane 0's output, since
    every lane holds the psum) against each (data, model) rank's
    ``moe_ffn_dist``: the output, the grads of the shard's rows, the
    router (copy-to-model sums it over model) and the rank's experts."""
    got = worlds[0]
    case = _ep_case(mesh, t)
    d_ways, m_ways = mesh
    e = case["w_router"].shape[1]
    drops = 0
    for dr in range(d_ways):
        rows = slice(dr * t // d_ways, (dr + 1) * t // d_ways)
        x_l, r_l = jnp.asarray(case["x"][rows]), jnp.asarray(case["r"][rows])
        stack = [jnp.asarray(case[k]).reshape(m_ways, e // m_ways,
                                              *case[k].shape[1:])
                 for k in ("w_gate", "w_up", "w_down")]

        def loss(x, wr, g, u, dn, r):
            out = jax.vmap(lambda g_, u_, d_: moe_ffn_local_ep(
                x, wr, g_, u_, d_, top_k=case["top_k"], e_total=e,
                model_axis="model", capacity_factor=case["cf"]),
                axis_name="model")(g, u, dn)
            return jnp.sum(out[0] * r), out[0]

        (_, y), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            x_l, jnp.asarray(case["w_router"]), *stack, r_l)
        y, grads = np.asarray(y), [np.asarray(g) for g in grads]
        cap = max(1, int(x_l.shape[0] * case["top_k"] * case["cf"]) // e)
        topi = np.argsort(-(np.asarray(x_l) @ case["w_router"]), -1)[
            :, :case["top_k"]]
        drops += int(np.maximum(np.bincount(topi.ravel(), minlength=e)
                                - cap, 0).sum())
        for mr in range(m_ways):
            ty, tgx, tgr, tgw = got[("ep", mesh, t)][dr * m_ways + mr]
            for a, b in ((ty, y), (tgx, grads[0]), (tgr, grads[1])):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=EP_TOL * np.abs(b).max())
            for a, b in zip(tgw, grads[2:]):
                np.testing.assert_allclose(a, b[mr], rtol=0,
                                           atol=EP_TOL * np.abs(b).max())
    assert drops > 0          # the case exercises capacity drops


# ---------------------------------------------------------------------------
# the sharded step vs JAX's single-device step
# ---------------------------------------------------------------------------

STEP_CASES = [(a, m) for a in ARCHS for m in MESHES[a]]


def _check_grads(got_tree, want_tree):
    for g, w in zip(tree_leaves(store.from_host(got_tree)),
                    jax.tree_util.tree_leaves(want_tree)):
        w, g = _f32(w), g.float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-30)


@pytest.mark.parametrize("arch,mesh", STEP_CASES)
def test_sharded_step_matches_jax_single_device(worlds, arch, mesh):
    """The sharded grads (gathered) and loss against JAX's, with two
    microbatches; one sharded train step's gathered params against JAX's
    whole step; its grad norm and metrics world-equal to JAX's."""
    got, refs = worlds[0][("step", arch, mesh)][0], worlds[1][arch]
    want = refs["metrics"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert got["step_metrics"]["loss"] == got["loss"]
    _check_grads(got["grads"], refs["grads"])
    assert got["step_metrics"]["grad_norm"] == pytest.approx(
        want["grad_norm"], rel=1e-5)
    new = store.from_host(got["state"])
    for p, w in zip(tree_leaves(new.params),
                    jax.tree_util.tree_leaves(refs["new"].params)):
        w = _f32(w)
        assert (np.abs(p.numpy() - w) <= 1e-6 * np.abs(w).max()
                + 2 * LR).all()
    assert int(new.opt.step) == 1


@pytest.mark.parametrize("arch,mesh", STEP_CASES)
def test_compressed_payload_equals_one_device(worlds, arch, mesh):
    """``compress_grads`` on each rank's slices of the one-device grads,
    with each leaf's scale from its global amax: the gathered int8
    payload equals the one-device payload bit for bit."""
    got = worlds[0][("step", arch, mesh)][0]
    q, _ = compress_grads(worlds[1][arch]["grads_1x1"])
    for a, b in zip(tree_leaves(store.from_host(got["payload"])),
                    tree_leaves(_payload(q))):
        assert a.dtype == torch.int8 and torch.equal(a, b)


@pytest.mark.parametrize("arch,mesh", STEP_CASES)
def test_replicated_leaves_bit_equal_across_ranks(worlds, arch, mesh):
    """After a step every leaf whole over model holds the same bits on
    every model rank, and a leaf whole over data too on every rank
    (model rank 0's grad is broadcast; the data sum is one all-reduce)."""
    ranks = [r["replicated"] for r in worlds[0][("step", arch, mesh)]]
    assert len(ranks) == mesh[0] * mesh[1] and ranks[0][1]
    for d, sums in ranks:
        row0 = ranks[d * mesh[1]][1]
        assert sums == row0
        assert [s for whole, s in sums if whole] == \
            [s for whole, s in ranks[0][1] if whole]
    assert any(whole for whole, _ in ranks[0][1])


# ---------------------------------------------------------------------------
# the placement vs JAX's spec_for
# ---------------------------------------------------------------------------

class _MeshShape:
    """What the reference's ``spec_for`` reads of a mesh."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _jax_specs(tree, prefix=""):
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else k
        if isinstance(v, JParamSpec):
            yield path, v
        else:
            yield from _jax_specs(v, path)


def _placement_at(placements, path):
    for k in path.split("/"):
        placements = placements[k]
    return placements


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_train_placement_matches_jax_spec_for(arch, mesh):
    """Every leaf of the smoke schema: the port's ``spec_for`` equals the
    reference's, and the train placement cuts the dims it names (the
    embedding table whole over model, the stated exception)."""
    tschema = build_schema(get_config(arch, smoke=True))
    pls = train_placements(tschema, *mesh)
    n = 0
    for path, js in _jax_specs(jschema(JSMOKES[arch])):
        ts = _placement_at(tschema, path)
        assert (tuple(ts.shape), tuple(ts.axes)) == (tuple(js.shape),
                                                     tuple(js.axes))
        want = tuple(jspec_for(js.axes, js.shape, _MeshShape(*mesh)))
        assert spec_for(ts.axes, ts.shape,
                        {"data": mesh[0], "model": mesh[1]}) == want
        dims = {ax: i for i, ax in enumerate(want) if ax is not None}
        if path == "embed/table":
            dims.pop("model", None)
        assert _placement_at(pls, path) == Placement(dims.get("data"),
                                                     dims.get("model"))
        n += 1
    assert n > 10
    if arch == "deepseek-moe-16b" and mesh == (2, 2):
        layer = pls["stages"]["s1"]["p0"]
        assert layer["wq"] == Placement(1, 2)
        assert layer["moe"]["w_gate"] == Placement(2, 1)
        assert layer["moe"]["w_router"] == Placement(1, None)
        assert layer["ln"]["gamma"] == Placement()
        assert pls["embed"]["table"] == Placement(1, None)


@pytest.mark.parametrize("micro,rank,want", [
    (4, 0, [0, 1, 4, 5]), (4, 1, [2, 3, 6, 7]), (0, 1, [4, 5, 6, 7])])
def test_data_rows_take_each_microbatch_slice(micro, rank, want):
    assert data_rows(8, micro, rank, 2).tolist() == want


# ---------------------------------------------------------------------------
# checkpoints across mesh shapes
# ---------------------------------------------------------------------------

def test_mesh_checkpoint_is_the_gathered_tree(worlds, tmp_path):
    """The 2x2 checkpoint holds the whole tree: bit-equal, leaf for leaf,
    to a one-device save of the gathered state."""
    got, _, _, ck = worlds
    at = store.from_host(got["ckpt"][0]["at_ckpt"])
    store.save(str(tmp_path), at, CKPT_STEPS)
    a = store.restore(ck, CKPT_STEPS, at)
    b = store.restore(str(tmp_path), CKPT_STEPS, at)
    assert all(torch.equal(x, y) for x, y in zip(store.flatten(a),
                                                 store.flatten(b)))
    assert all(torch.equal(x, y) for x, y in zip(store.flatten(a),
                                                 store.flatten(at)))


@pytest.mark.parametrize("where", ["1x1", "1x2", "1x1_at_2x2"])
def test_mesh_checkpoint_restores_across_shapes(worlds, where):
    """Restored at 1x1 (the one-device step) and at 1x2 (a mesh), the 2x2
    checkpoint continues as the uninterrupted 2x2 run; and the reverse, a
    one-device checkpoint restored at 2x2 continues as the one-device
    run: the loss within 1e-5, the params within 2 lr."""
    got, refs, batches, ck = worlds
    want = got["ckpt"][0]
    if where == "1x1_at_2x2":
        want = got["one_device"][0]
        r = got["restore_1x1"][0]
        loss, after = r["loss"], store.from_host(r["after"])
    elif where == "1x1":
        tc = _tc(refs["deepseek-moe-16b"]["jc"])
        like = store.from_host(want["at_ckpt"])
        state = store.restore(ck, store.latest_step(ck), like)
        step = TS.make_train_step(tc, OptConfig(**OCFG), _knobs(TS))
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batches[CKPT_STEPS].items()})
        loss, after = float(m["loss"]), state
    else:
        r = got["restore"][0]
        loss, after = r["loss"], store.from_host(r["after"])
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for p, w in zip(store.flatten(after.params),
                    store.flatten(store.from_host(want["after"]).params)):
        assert (torch.abs(p - w) <= 2 * LR).all()
    assert int(after.opt.step) == CKPT_STEPS + 1


# ---------------------------------------------------------------------------
# the CLI on a mesh
# ---------------------------------------------------------------------------

def test_mesh_cli_fault_equals_clean(tmp_path, capsys):
    """``launch/train.main --data-axis 2`` on the CPU (gloo): a run with
    an injected failure and async checkpoints ends bit-equal to a clean
    run, after one restart; rank 0's lines are printed."""
    base = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--data-axis", "2", "--steps", "6", "--ckpt-every", "2",
            "--batch", "4", "--seq", "32", "--microbatch", "2",
            "--log-every", "3"]
    clean = train.main(base + ["--ckpt-dir", str(tmp_path / "clean")])
    fault = train.main(base + ["--ckpt-dir", str(tmp_path / "fault"),
                               "--inject-fail", "3", "--async-ckpt"])
    out = capsys.readouterr().out
    assert clean["report"].restarts == 0 and fault["report"].restarts == 1
    assert fault["report"].steps_run == 7 and len(fault["losses"]) == 7
    assert all(np.isfinite(clean["losses"]))
    assert out.count("done: LoopReport(steps_run=") == 2
    for a, b in zip(store.flatten(clean["state"]),
                    store.flatten(fault["state"])):
        assert torch.equal(a, b)
    assert store.latest_step(str(tmp_path / "fault")) == 6
    whole = store.restore(str(tmp_path / "fault"), 6, clean["state"])
    assert all(torch.equal(a, b) for a, b in zip(
        store.flatten(whole), store.flatten(clean["state"])))


def test_mesh_cli_trains_2x2(tmp_path, capsys):
    """``--data-axis 2 --model-axis 2`` of the MoE smoke arch: finite
    losses, the state gathered whole (the one-device tree's shapes)."""
    r = train.main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                    "cpu", "--data-axis", "2", "--model-axis", "2",
                    "--steps", "2", "--batch", "4", "--seq", "16",
                    "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert "step     2 loss" in capsys.readouterr().out
    assert all(np.isfinite(r["losses"])) and len(r["losses"]) == 2
    want = build_schema(get_config("deepseek-moe-16b", smoke=True))
    for path, js in _jax_specs(jschema(JSMOKES["deepseek-moe-16b"])):
        assert tuple(_placement_at(r["state"].params, path).shape) == \
            tuple(js.shape) == tuple(_placement_at(want, path).shape)

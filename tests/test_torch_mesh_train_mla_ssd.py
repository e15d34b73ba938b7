"""Port parity, mesh training of MLA and SSD layers: the train step on a
("data", "model") mesh of gloo ranks (``launch/steps.py`` with ``mesh=``)
for deepseek-v3's absorbed MLA with its MTP block and routed experts on
the expert axis, mamba2's SSD mixer and jamba's hybrid of GQA, SSD and
MoE, against JAX's single-device step; the SSD gated norm's model-group
sum against JAX's ``gated_rms_norm``; the train placement (the SSD
mixer's segmented cut) against JAX's ``spec_for``; mamba2 checkpoints
across mesh shapes; the CLI.

One world of 2 ranks and then one of 4 run every rank job of the module
(the world of 2 writes the 1x2 checkpoint the world of 4 restores); the
rank functions live in ``tests/_torch_worlds.py`` and import no JAX.
JAX runs here, in-process, on one CPU device.

Tolerances (``tests/test_torch_mesh_train.py``'s contract): loss within
1e-5 of JAX's, relative; each gathered grad leaf within 1e-4 of that
leaf's max |g|; params within 2 lr of JAX's step. The gated norm's
output and grads within 1e-5 of each tensor's max (the mean of squares
summed in another order). Leaves whole over model and an SSD mixer's
B/C runs held whole are bit-equal across model ranks; the int8
compression payload is bit-equal to the one-device payload.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import spec_for as jspec_for
from repro.launch import steps as JS
from repro.models.registry import SMOKES as JSMOKES
from repro.models.schema import ParamSpec as JParamSpec
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.models.ssd import gated_rms_norm as jgated_rms_norm
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import adamw_update as jadamw
from repro.optim.adamw import init_opt_state as jinit_opt
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_train_state
from repro_torch.distributed.sharding import (MeshCoords, Placement,
                                              TrainShards, spec_for,
                                              train_placements)
from repro_torch.distributed.tp import validate_tp_config
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.schema import init_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.optim.adamw import OptConfig, compress_grads, tree_leaves

from _torch_worlds import _payload, mesh_train_world

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4       # of the leaf's max |g|
NORM_TOL = 1e-5       # of the tensor's max
OCFG = dict(warmup_steps=1, total_steps=4)
LR = 3e-4
B, S_LEN, MB = 4, 16, 2          # two microbatches of 2
ARCHS = ("deepseek-v3-671b", "mamba2-2.7b", "jamba-v0.1-52b")
MESHES = {"deepseek-v3-671b": ((1, 2), (2, 2)),
          "mamba2-2.7b": ((1, 2), (2, 2)),
          "jamba-v0.1-52b": ((1, 2),)}
STEP_CASES = [(a, m) for a in ARCHS for m in MESHES[a]]
CKPT_ARCH, CKPT_STEPS = "mamba2-2.7b", 2
# the SSD leaves whose model cut is segmented where the reference's is
# contiguous (w_in) or absent (the conv: its "conv" axis maps nowhere)
SEGMENTED = ("w_in", "conv_w", "conv_b")
GNORM = dict(shape=(2, 6, 32), eps=1e-6)


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


def _jax_start(arch):
    """JAX's seed-0 params with zeroed moments, and one batch."""
    jc = _jc(arch)
    params = jinit(jschema(jc), jax.random.PRNGKey(0))
    jstate = JS.TrainState(params, jinit_opt(params, JOptConfig(**OCFG)))
    return dict(jc=jc, jstate=jstate, start=_np(jstate),
                batch=_batch(jc, 1))


def _jax_reference(ref):
    """JAX's train step from ``_jax_start``'s state on its batch, composed
    as ``tests/test_torch_mesh_train.py`` composes it: the microbatches'
    jitted ``value_and_grad`` of ``loss_fn`` summed in order from zeros,
    / n; then ``adamw_update``."""
    jc, jstate = ref["jc"], ref["jstate"]
    params = jstate.params
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
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
    ref.update(new=_np(JS.TrainState(new_params, opt)),
               metrics=dict({k: float(v) for k, v in om.items()},
                            loss=float(lsum / n)),
               grads=_np(grads))


def _gnorm_case(seed=5):
    rng = np.random.default_rng(seed)
    shape = GNORM["shape"]
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    return dict(y=draw(*shape), z=draw(*shape), r=draw(*shape),
                gn=draw(shape[-1]) * 0.3, eps=GNORM["eps"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank job of the module: the world of 2 first (it writes the
    1x2 checkpoint), then the world of 4 (which restores it), in a
    thread while JAX's steps compile and run here. Returns (each job's
    results by id, a list of its ranks', the JAX references by arch, the
    checkpoint's batches and directory)."""
    refs = {arch: _jax_start(arch) for arch in ARCHS}
    case = _gnorm_case()
    jobs = [dict({k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                  else v for k, v in case.items()},
                 id="gnorm", mesh=(1, 2), kind="gnorm")]
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
    ck = str(tmp_path_factory.mktemp("ssd_mesh_ckpt"))
    ssd = refs[CKPT_ARCH]
    batches = [_batch(ssd["jc"], 10 + i) for i in range(CKPT_STEPS + 1)]
    common = dict(cfg=_tc(ssd["jc"]), state=convert_train_state(
        ssd["start"]), ocfg=OptConfig(**OCFG), knobs=_knobs(TS),
        batches=batches, dir=ck)
    jobs.append(dict(common, id="ckpt", mesh=(1, 2), kind="ckpt",
                     steps=CKPT_STEPS))
    jobs.append(dict(common, id="restore", mesh=(2, 2), kind="restore"))

    def run_worlds():
        got = {}
        for world in (2, 4):
            ranks = spawn_world(mesh_train_world, world, jobs,
                                deadline_s=300)
            for jid in ranks[0]:
                got[jid] = [r[jid] for r in ranks]
        return got

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        worlds_done = pool.submit(run_worlds)
        for ref in refs.values():
            _jax_reference(ref)
        got = worlds_done.result()
    return got, refs, batches, ck


# ---------------------------------------------------------------------------
# the sharded step vs JAX's single-device step
# ---------------------------------------------------------------------------

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
    whole step; its grad norm world-equal to JAX's."""
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
        assert p.shape == w.shape
        assert (np.abs(p.numpy() - w) <= 1e-6 * np.abs(w).max()
                + 2 * LR).all()
    assert int(new.opt.step) == 1


@pytest.mark.parametrize("arch,mesh", STEP_CASES)
def test_compressed_payload_equals_one_device(worlds, arch, mesh):
    """``compress_grads`` on each rank's slices of the one-device grads
    (segmented leaves included), each leaf's scale from its global amax:
    the gathered int8 payload equals the one-device payload bit for
    bit."""
    got = worlds[0][("step", arch, mesh)][0]
    q, _ = compress_grads(worlds[1][arch]["grads_1x1"])
    for a, b in zip(tree_leaves(store.from_host(got["payload"])),
                    tree_leaves(_payload(q))):
        assert a.dtype == torch.int8 and torch.equal(a, b)


@pytest.mark.parametrize("arch,mesh", STEP_CASES)
def test_replicated_leaves_bit_equal_across_ranks(worlds, arch, mesh):
    """After a step every leaf whole over model, and every run of a
    segmented leaf held whole (the SSD mixer's B/C columns of ``w_in``
    and channels of the conv: one group), holds the same bits on every
    model rank; one whole over data too on every rank."""
    ranks = [r["replicated"] for r in worlds[0][("step", arch, mesh)]]
    assert len(ranks) == mesh[0] * mesh[1] and ranks[0][1]
    for d, sums in ranks:
        assert sums == ranks[d * mesh[1]][1]
        assert [s for whole, s in sums if whole] == \
            [s for whole, s in ranks[0][1] if whole]
    pls = store.flatten(train_placements(
        build_schema(get_config(arch, smoke=True)), *mesh))
    runs = sum(len(pl.local_runs(mesh[1])) - sum(
        cut for _, cut in pl.local_runs(mesh[1]))
        for pl in pls if pl.segments)
    whole = sum(pl.model_dim is None for pl in pls)
    assert len(ranks[0][1]) == whole + runs
    # B and C whole in each segmented leaf (one group); MLA has none
    assert runs == 2 * sum(1 for pl in pls if pl.segments)
    assert (runs > 0) == (arch != "deepseek-v3-671b")


# ---------------------------------------------------------------------------
# the gated norm's model-group sum
# ---------------------------------------------------------------------------

def test_gated_norm_model_group_sum_matches_jax(worlds):
    """At 2 model ranks, each holding half of the channels: the output
    and the grads of y, z and the gain (through copy-to-model and the
    rank's slice, as the train step enters it) against JAX's
    ``gated_rms_norm`` and ``jax.grad`` on the whole channels."""
    case = _gnorm_case()
    ranks = worlds[0]["gnorm"]

    def loss(y, z, gn):
        out = jgated_rms_norm(y, z, gn, case["eps"])
        return jnp.sum(out * case["r"]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(case[k]) for k in ("y", "z", "gn")))
    want = [np.asarray(t) for t in (out,) + grads]
    width = case["y"].shape[-1] // len(ranks)
    for r, (o, gy, gz, ggn) in enumerate(ranks):
        cols = slice(r * width, (r + 1) * width)
        for a, b in ((o, want[0][..., cols]), (gy, want[1][..., cols]),
                     (gz, want[2][..., cols]), (ggn, want[3])):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=NORM_TOL * np.abs(b).max())


# ---------------------------------------------------------------------------
# the placement vs JAX's spec_for, the segmented cut, the refusals
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


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 1)])
def test_train_placement_matches_jax_spec_for(arch, mesh):
    """Every leaf of the smoke schema: the port's ``spec_for`` equals the
    reference's; the train placement cuts the dim it names over data for
    every leaf, and over model for every leaf but the stated exceptions:
    the embedding table (whole over model) and, above one model rank,
    the SSD mixer's ``w_in``, ``conv_w`` and ``conv_b``, cut by segment on
    their last dim."""
    tschema = build_schema(get_config(arch, smoke=True))
    pls = train_placements(tschema, *mesh)
    n = segmented = 0
    for path, js in _jax_specs(jschema(JSMOKES[arch])):
        ts = _at(tschema, path)
        assert (tuple(ts.shape), tuple(ts.axes)) == (tuple(js.shape),
                                                     tuple(js.axes))
        want = tuple(jspec_for(js.axes, js.shape, _MeshShape(*mesh)))
        assert spec_for(ts.axes, ts.shape,
                        {"data": mesh[0], "model": mesh[1]}) == want
        dims = {ax: i for i, ax in enumerate(want) if ax is not None}
        pl = _at(pls, path)
        assert pl.data_dim == dims.get("data")
        key = path.rsplit("/", 1)[-1]
        if path == "embed/table":
            assert pl.model_dim is None
        elif key in SEGMENTED and mesh[1] > 1:
            assert pl.model_dim == len(js.shape) - 1 and pl.segments
            assert sum(w for w, _ in pl.segments) == js.shape[-1]
            segmented += 1
        else:
            assert pl == Placement(dims.get("data"), dims.get("model"))
        n += 1
    assert n > 10
    n_ssd = sum(1 for p, _ in _jax_specs(jschema(JSMOKES[arch]))
                if p.endswith("/w_in"))
    assert segmented == (3 * n_ssd if mesh[1] > 1 else 0)
    assert (n_ssd > 0) == (arch != "deepseek-v3-671b")


@pytest.mark.parametrize("model_ways", [2, 4])
def test_segmented_cut_round_trips(model_ways):
    """mamba2's smoke w_in and conv at ``model_ways``: each rank's cut is
    its heads' slice of z, x and dt and B and C whole (one group), in
    that order, and the model ranks' pieces join back into the whole
    leaf."""
    cfg = get_config("mamba2-2.7b", smoke=True)
    schema = build_schema(cfg)
    layer = init_params(schema, 0, "cpu")["stages"]["s0"]["p0"]
    pls = train_placements(schema, 1, model_ways)
    din, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    xbc = [(0, din, True), (din, gn, False), (din + gn, gn, False)]
    runs_of = {"w_in": [(0, din, True)] + [(lo + din, n, c)
                                          for lo, n, c in xbc]
               + [(2 * din + 2 * gn, din // cfg.ssm_head_dim, True)],
               "conv_w": xbc, "conv_b": xbc}
    for key, runs in runs_of.items():
        whole, pl = layer[key], pls["stages"]["s0"]["p0"][key]
        shards = [TrainShards(pls, MeshCoords(0, 1, r, model_ways))
                  for r in range(model_ways)]
        pieces = [sh.cut(whole, pl) for sh in shards]
        assert torch.equal(shards[0].join_model(pieces, pl), whole)
        for r, piece in enumerate(pieces):
            held = piece.split([w for w, _ in pl.local_runs(model_ways)], -1)
            assert len(held) == len(runs)
            for got, (lo, n, cut) in zip(held, runs):
                if cut:
                    lo, n = lo + r * n // model_ways, n // model_ways
                assert torch.equal(got, whole[..., lo:lo + n])


def test_ssd_splits_the_mesh_cannot_take_raise():
    """An SSD config's heads a model axis does not divide, or groups that
    neither divide nor are one, raise naming the field; the three archs'
    smoke configs shard at 2 ways."""
    mamba = get_config("mamba2-2.7b", smoke=True)       # 8 heads, 1 group
    with pytest.raises(ValueError, match="SSD heads"):
        validate_tp_config(mamba, 3)
    with pytest.raises(ValueError, match="ssm_groups=2"):
        validate_tp_config(mamba.replace(ssm_groups=2), 4)
    validate_tp_config(mamba.replace(ssm_groups=2), 2)
    for arch in ARCHS:
        validate_tp_config(get_config(arch, smoke=True), 2)


# ---------------------------------------------------------------------------
# checkpoints across mesh shapes, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["1x1", "2x2"])
def test_ssd_mesh_checkpoint_restores_across_shapes(worlds, where):
    """mamba2's checkpoint saved at 1x2 (the whole tree, the segmented
    leaves joined), restored at 1x1 (the one-device step) and at 2x2 (a
    mesh), continues as the uninterrupted 1x2 run: the loss within 1e-5,
    the params within 2 lr."""
    got, refs, batches, ck = worlds
    want = got["ckpt"][0]
    if where == "1x1":
        tc = _tc(refs[CKPT_ARCH]["jc"])
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
        assert p.shape == w.shape and (torch.abs(p - w) <= 2 * LR).all()
    assert int(after.opt.step) == CKPT_STEPS + 1


def test_mesh_cli_trains_ssd_on_model_axis(tmp_path, capsys):
    """``--arch mamba2-2.7b --smoke --device cpu --model-axis 2``: finite
    losses, the state gathered whole (the one-device tree's shapes)."""
    r = train.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                    "--model-axis", "2", "--steps", "2", "--batch", "4",
                    "--seq", "16", "--ckpt-dir", str(tmp_path),
                    "--log-every", "1"])
    assert "step     2 loss" in capsys.readouterr().out
    assert all(np.isfinite(r["losses"])) and len(r["losses"]) == 2
    for path, js in _jax_specs(jschema(JSMOKES["mamba2-2.7b"])):
        assert tuple(_at(r["state"].params, path).shape) == tuple(js.shape)

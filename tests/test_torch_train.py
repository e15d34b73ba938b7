"""Port parity, the train step (``launch/steps.py``'s train half): the
same ``TrainState`` (JAX's params and zeroed ``OptState``, carried into
the port by ``convert.convert_train_state``) and the same numpy batch go
through one JAX step and one port step, at f32 smoke configs; the
reference's own smoke check (two finite steps, no blow-up) on every
smoke arch; hubert's bidirectional forward; ``chunked_ce`` against
``_xent`` over the whole logits. Each JAX function is jitted once a
module and arch.

Tolerances, stated per quantity:
  * loss within 1e-5 of JAX's, relative;
  * each grad leaf within 1e-4 of that leaf's max |g| (f32 sums in other
    orders than XLA's);
  * the step's update against JAX's ``adamw_update`` of the port's own
    grads: params within 1e-6 x the leaf's max |p|, the bf16 moments
    within one bf16 ulp; against JAX's whole step (its own grads) params
    within 2 x lr: a first Adam step moves an element by lr x
    g / (|g| + eps) plus the decay, and a grad that is 0 but for rounding
    (starcoder2's k bias: softmax ignores it) may take either sign.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.registry import SMOKES as JSMOKES
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import adamw_update as jadamw
from repro.optim.adamw import compress_grads as jcompress
from repro.optim.adamw import decompress_grads as jdecompress
from repro.optim.adamw import init_opt_state as jinit_opt
from repro_torch.configs import SMOKES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_train_state, convert_tree
from repro_torch.launch import steps as TS
from repro_torch.launch.train import build_state
from repro_torch.models import model as TM
from repro_torch.optim.adamw import OptConfig, tree_leaves

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4       # of the leaf's max |g|
PARAM_TOL = 1e-6      # of the leaf's max |p|
OCFG = dict(warmup_steps=1, total_steps=4)
LR = 3e-4             # cosine_lr at step 1 of OCFG: the full rate
KNOBS = dict(microbatch=0, ce_chunk=8)
PARITY = ("granite-8b", "starcoder2-3b", "hubert-xlarge", "deepseek-moe-16b",
          "mamba2-2.7b", "paligemma-3b", "deepseek-v3-671b")


def _batch(cfg, b=2, s=24, seed=0):
    """The reference's smoke batch shapes (``tests/test_models.py``),
    drawn with numpy: frames for an encoder, patches + tokens for a VLM
    (targets over its text positions), tokens otherwise."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encoder":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        tgt = s
    elif cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)
        tgt = s - cfg.n_prefix
        out["tokens"] = rng.integers(0, cfg.vocab, (b, tgt)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        tgt = s
    out["targets"] = rng.integers(0, cfg.vocab, (b, tgt)).astype(np.int32)
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def tconfig(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _check_grads(got_tree, want_tree):
    for g, w in zip(tree_leaves(got_tree), jax.tree_util.tree_leaves(
            want_tree)):
        w = _f32(w)
        g = g.float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-30)


def _bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _check_state(got, want, close=True, lr=LR):
    """The port's updated TrainState against JAX's (module docstring):
    with ``close`` (JAX's update of the same grads) params within
    PARAM_TOL of each leaf's max |p| and bf16 moments within one bf16
    ulp; otherwise (JAX's own grads) params within 2 lr."""
    for p, w in zip(tree_leaves(got.params),
                    jax.tree_util.tree_leaves(want.params)):
        w, p = _f32(w), p.numpy()
        tol = PARAM_TOL * np.abs(w).max() + (0 if close else 2 * lr)
        assert (np.abs(p - w) <= tol).all(), np.abs(p - w).max()
    if close:
        for name in ("mu", "nu"):
            for m, w in zip(tree_leaves(getattr(got.opt, name)),
                            jax.tree_util.tree_leaves(getattr(want.opt,
                                                              name))):
                w = _f32(w)
                assert m.dtype == torch.bfloat16
                assert (np.abs(m.float().numpy() - w) <= _bf16_ulp(w)).all()
    assert int(got.opt.step) == int(want.opt.step) == 1


@pytest.fixture(scope="module", params=PARITY)
def parity(request):
    """JAX's loss, grads and AdamW update on one smoke batch (jitted
    once), from seed-0 params; the port's step from the same state."""
    arch = request.param
    jc = JSMOKES[arch].replace(dtype="float32")
    tc = tconfig(jc)
    params = jinit(jschema(jc), jax.random.PRNGKey(0))
    jstate = JS.TrainState(params, jinit_opt(params, JOptConfig(**OCFG)))
    batch = _batch(jc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(jc, JS.TrainKnobs(**KNOBS), p, b),
        has_aux=True))(params, _jbatch(batch))
    update = jax.jit(lambda p, g, s: jadamw(p, g, s, JOptConfig(**OCFG)))
    new_params, opt, om = update(params, grads, jstate.opt)
    return dict(arch=arch, jc=jc, tc=tc, batch=batch, jstate=jstate,
                update=update, start=_np(jstate), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_np(grads), om={k: float(v) for k, v in om.items()},
                new=_np(JS.TrainState(new_params, opt)))


def _jax_update_of(update, jstate, grads):
    """JAX's ``adamw_update`` of the port's grads (a torch tree), as a
    numpy TrainState."""
    g = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jstate.params),
        [jnp.asarray(t.numpy()) for t in tree_leaves(grads)])
    new_params, opt, _ = update(jstate.params, g, jstate.opt)
    return _np(JS.TrainState(new_params, opt))


def test_train_step_grads_match_jax(parity):
    """``make_accum_grads``: the loss (CE + aux + MTP), its metrics and
    every grad leaf against JAX's ``value_and_grad`` of ``loss_fn``."""
    tc = parity["tc"]
    state = convert_train_state(parity["start"])
    loss, metrics, grads = TS.make_accum_grads(tc, TS.TrainKnobs(**KNOBS))(
        state.params, _tbatch(parity["batch"]))
    assert abs(float(loss) - parity["loss"]) <= LOSS_RTOL * abs(
        parity["loss"])
    assert set(metrics) == set(parity["metrics"])
    for k, v in parity["metrics"].items():
        assert abs(float(metrics[k]) - v) <= LOSS_RTOL * max(abs(v), 1.0)
    _check_grads(grads, parity["grads"])


def test_train_step_update_matches_jax(parity):
    """One ``make_train_step`` call (grads, then the in-place AdamW
    update): the updated params and bf16 moments against JAX's
    ``adamw_update`` of the port's grads (close) and of JAX's own (params
    within 2 lr); the step, the grad norm and the rate."""
    tc = parity["tc"]
    knobs = TS.TrainKnobs(**KNOBS)
    _, _, grads = TS.make_accum_grads(tc, knobs)(
        convert_train_state(parity["start"]).params,
        _tbatch(parity["batch"]))
    state = convert_train_state(parity["start"])
    step = TS.make_train_step(tc, OptConfig(**OCFG), knobs)
    new, metrics = step(state, _tbatch(parity["batch"]))
    assert new.params is state.params          # updated in place
    _check_state(new, _jax_update_of(parity["update"], parity["jstate"],
                                     grads))
    _check_state(new, parity["new"], close=False)
    assert abs(float(metrics["grad_norm"]) - parity["om"]["grad_norm"]) \
        <= 1e-5 * parity["om"]["grad_norm"]
    assert float(metrics["lr"]) == pytest.approx(parity["om"]["lr"],
                                                 rel=1e-6)


@pytest.fixture(scope="module")
def granite_steps():
    """JAX's whole train step (jitted) on the granite smoke config at
    f32, with two microbatches and with int8 gradient compression."""
    jc = JSMOKES["granite-8b"].replace(dtype="float32")
    params = jinit(jschema(jc), jax.random.PRNGKey(1))
    jstate = JS.TrainState(params, jinit_opt(params, JOptConfig(**OCFG)))
    batch = _batch(jc, b=4, seed=5)
    out = {}
    for name, kw in (("microbatch", dict(microbatch=2, ce_chunk=8)),
                     ("compress", dict(ce_chunk=16,
                                       compress_pod_grads=True))):
        knobs = JS.TrainKnobs(**kw)
        new, m = jax.jit(JS.make_train_step(jc, JOptConfig(**OCFG), knobs))(
            jstate, _jbatch(batch))
        out[name] = (kw, _np(new), {k: float(v) for k, v in m.items()})
    # one microbatch's grads (the microbatch case's per-microbatch term)
    knobs = JS.TrainKnobs(ce_chunk=8)
    grads = jax.jit(jax.grad(lambda p, b: JS.loss_fn(jc, knobs, p, b)[0]))
    update = jax.jit(lambda p, g, s: jadamw(p, g, s, JOptConfig(**OCFG)))
    return dict(jc=jc, start=_np(jstate), batch=batch, grads=grads,
                steps=out, params=params, jstate=jstate, update=update)


@pytest.mark.parametrize("name", ["microbatch", "compress"])
def test_train_step_variants_match_jax(granite_steps, name):
    """Two microbatches of 2 (the grads summed 0 + g1 + g2, then / 2, as
    JAX's scan sums them) and int8 gradient compression (quantized and
    dequantized in the step): the loss, metrics and updated state against
    JAX's whole step."""
    kw, want, jm = granite_steps["steps"][name]
    tc = tconfig(granite_steps["jc"])
    state = convert_train_state(granite_steps["start"])
    knobs = TS.TrainKnobs(**kw)
    new, m = TS.make_train_step(tc, OptConfig(**OCFG), knobs)(
        state, _tbatch(granite_steps["batch"]))
    assert set(m) == set(jm)
    assert abs(float(m["loss"]) - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
    state0 = convert_train_state(granite_steps["start"])
    _, _, grads = TS.make_accum_grads(tc, knobs)(
        state0.params, _tbatch(granite_steps["batch"]))
    if name == "microbatch":
        # the grads against the mean of JAX's per-microbatch grads
        g = granite_steps["grads"]
        b = _jbatch(granite_steps["batch"])
        halves = [g(granite_steps["params"],
                    {k: v[i * 2:(i + 1) * 2] for k, v in b.items()})
                  for i in range(2)]
        _check_grads(grads, _np(jax.tree_util.tree_map(
            lambda x, y: (x + y) / 2, *halves)))
    else:
        # the step's update takes the int8 round trip of its grads: JAX's
        # compress_grads of the port's grads (bit-equal to the port's,
        # tests/test_torch_optim_data_ckpt.py)
        q, _ = jcompress(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), grads))
        grads = jax.tree_util.tree_map(lambda a: torch.from_numpy(
            np.array(a)), jdecompress(q))
    _check_state(new, _jax_update_of(granite_steps["update"],
                                     granite_steps["jstate"], grads))
    _check_state(new, want, close=False)


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_smoke_train_two_finite_steps(arch):
    """The reference's ``test_smoke_train_step`` on the port, every smoke
    arch at its own dtype (bf16 compute on f32 masters): two steps on one
    batch, the first loss finite, the second below the first + 1.0."""
    cfg = get_config(arch, smoke=True)
    ocfg = OptConfig(**OCFG)
    state = build_state(cfg, ocfg, 0, "cpu")
    batch = _tbatch(_batch(cfg, seed=1))
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(cfg.cdtype)
    step = TS.make_train_step(cfg, ocfg, TS.TrainKnobs(**KNOBS))
    state, m = step(state, batch)
    l1 = float(m["loss"])
    assert np.isfinite(l1)
    state, m = step(state, batch)
    assert float(m["loss"]) < l1 + 1.0
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))


def test_hubert_bidirectional_forward_matches_jax():
    """hubert-xlarge's smoke config at f32: ``forward`` on frames (the
    stub frontend's), bidirectional attention, against JAX's, within
    1e-5 of max |logit|; a later frame changes an earlier position's
    output (no causal mask); the serving paths refuse the encoder."""
    jc = JSMOKES["hubert-xlarge"].replace(dtype="float32")
    tc = tconfig(jc)
    params = jinit(jschema(jc), jax.random.PRNGKey(2))
    frames = np.random.default_rng(4).standard_normal(
        (2, 24, jc.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f: JM.forward(
        jc, p, {"frames": f}))(params, jnp.asarray(frames)))
    tp = convert_tree(_np(params))
    got = TM.forward(tc, tp, {"frames": torch.from_numpy(frames)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    later = frames.copy()
    later[:, -1] = np.random.default_rng(5).standard_normal(
        later[:, -1].shape)
    moved = TM.forward(tc, tp, {"frames": torch.from_numpy(later)}).numpy()
    assert np.abs(moved[:, 0] - got[:, 0]).max() > 1e-4
    with pytest.raises(NotImplementedError, match="encoder"):
        TM.check_contiguous_support(tc)
    with pytest.raises(NotImplementedError, match="encoder"):
        TM.check_paged_support(tc)


def test_forward_aux_and_remat():
    """deepseek-moe-16b's smoke config at f32: ``forward_hidden`` with
    ``remat`` gives the bits it gives without, and so do its grads; the
    aux loss is the sum of the MoE layers' ``load_balance_loss`` against
    JAX's ``forward(with_aux=True)`` within 1e-6, relative."""
    jc = JSMOKES["deepseek-moe-16b"].replace(dtype="float32")
    tc = tconfig(jc)
    params = jinit(jschema(jc), jax.random.PRNGKey(0))
    batch = _batch(jc, seed=2)
    jl, jaux = jax.jit(lambda p, b: JM.forward(jc, p, b, with_aux=True))(
        params, _jbatch(batch))
    tp = convert_tree(_np(params))
    outs = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
        from repro_torch.checkpoint.store import unflatten
        tree = unflatten(tp, leaves)
        logits, aux = TM.forward(tc, tree, _tbatch(batch), remat=remat,
                                 with_aux=True)
        (logits.float().square().mean() + aux).backward()
        outs.append((logits.detach(), aux.detach(),
                     [t.grad for t in leaves]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))
    assert float(outs[0][1]) == pytest.approx(float(jaux), rel=1e-6)
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())


@pytest.mark.parametrize("s,chunk", [(24, 8), (24, 5), (7, 16)])
def test_chunked_ce_equals_xent(s, chunk):
    """``chunked_ce`` (head + CE a chunk at a time under checkpoint, a
    ragged tail padded with target -1) equals ``_xent`` over the whole
    logits within 1e-6 relative, grads within 1e-6 of max |g|; and both
    equal JAX's ``chunked_ce`` within 1e-6 relative."""
    jc = JSMOKES["starcoder2-3b"].replace(dtype="float32")
    tc = tconfig(jc)
    params = jinit(jschema(jc), jax.random.PRNGKey(3))
    rng = np.random.default_rng(s + chunk)
    hidden = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    targets = rng.integers(0, jc.vocab, (2, s)).astype(np.int32)
    want = float(JS.chunked_ce(jc, params, jnp.asarray(hidden),
                               jnp.asarray(targets), chunk))
    tp = convert_tree(_np(params))
    vals = []
    for fn in (lambda h: TS.chunked_ce(tc, tp, h, torch.from_numpy(targets),
                                       chunk),
               lambda h: TS._xent(TM.head_logits(tc, tp, h),
                                  torch.from_numpy(targets))):
        h = torch.from_numpy(hidden).requires_grad_()
        loss = fn(h)
        loss.backward()
        vals.append((float(loss.detach()), h.grad))
    assert vals[0][0] == pytest.approx(vals[1][0], rel=1e-6)
    assert vals[0][0] == pytest.approx(want, rel=1e-6)
    g0, g1 = vals[0][1], vals[1][1]
    assert (g0 - g1).abs().max() <= 1e-6 * g1.abs().max()

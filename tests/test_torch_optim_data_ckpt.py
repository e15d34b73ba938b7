"""Port parity, training's substrate: AdamW and its gradient utilities
(``optim/adamw.py``), the synthetic pipeline's ``host_slice``,
``iter_batches`` and ``shard_batch`` (``data/pipeline.py``), and train
checkpoints (``checkpoint/store.py``: NamedTuples in JAX's leaf order,
``prune``, ``AsyncWriter``) against the JAX package, on the same numpy
inputs.

Tolerances: AdamW given JAX's grads, params within 1e-6 x max |p| and
bf16 moments within one bf16 ulp (f32 ops in the reference's order;
``pow`` and ``sqrt`` may round apart by an ulp), over three steps;
``cosine_lr`` within 1e-6 relative; ``global_norm`` within 1e-6
relative; ``compress_grads``' int8 ``q`` and f32 ``scale`` bit-equal;
batches, checkpoints and the leaf order exact.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import store
from repro_torch.convert import (convert_train_state, convert_tree,
                                 train_state_to_numpy)
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       shard_batch)
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw


def _tree(seed, scale=1.0):
    """A param-like tree (sorted-key order differs from insertion order),
    f32, with a stacked leaf."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((3, 8, 16)) * scale).astype(
                np.float32),
            "b": {"z": (rng.standard_normal((16,)) * scale).astype(
                np.float32),
                  "a": (rng.standard_normal((5, 4)) * scale).astype(
                np.float32)},
            "emb": (rng.standard_normal((11, 8)) * scale).astype(np.float32)}


def _t(tree):
    return convert_tree(tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
def test_adamw_given_jax_grads_matches(moment_dtype):
    """Three AdamW steps (clip active on the first: the grads' norm is
    above 1.0) from the same params and zeroed state, each step fed the
    same grads on both sides."""
    kw = dict(warmup_steps=2, total_steps=6, moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadamw.init_opt_state(jp, jcfg)
    tp = _t(params)
    ts = adamw.init_opt_state(tp, tcfg)
    assert ts.step.dtype == torch.int32 and ts.step.ndim == 0
    assert adamw.tree_leaves(ts.mu)[0].dtype == tcfg.mdtype
    update = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, jcfg))
    for i in range(3):
        grads = _tree(10 + i, scale=0.5 if i else 3.0)
        jp, js, jm = update(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                            js)
        tp, ts, tm = adamw.adamw_update(tp, _t(grads), ts, tcfg)
        assert int(ts.step) == int(js.step) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for g, w in zip(adamw.tree_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
        for name in ("mu", "nu"):
            for g, w in zip(adamw.tree_leaves(getattr(ts, name)),
                            _leaves(getattr(js, name))):
                w = w.astype(np.float32)
                err = np.abs(g.float().numpy() - w)
                if moment_dtype == "bfloat16":
                    assert (err <= _bf16_ulp(w)).all()
                else:
                    assert (err <= 1e-6 * np.abs(w).max()).all()


def test_adamw_slices_give_the_whole_leaf_bits(monkeypatch):
    """A leaf above ``SLICE_BYTES`` is updated (and summed for the norm) a
    run of its leading axis at a time, as many indices as fit the limit
    (one where a single one is larger): the updated params and moments
    equal the whole-leaf update's bits; the norm within 1e-6 relative.
    At two layers a run the norm sums in another order, so the bits are
    compared with the clip off."""
    def update(cfg, limit):
        monkeypatch.setattr(adamw, "SLICE_BYTES", limit)
        p = {k: v.clone() if not isinstance(v, dict) else
             {a: b.clone() for a, b in v.items()} for k, v in params.items()}
        s = adamw.init_opt_state(p, cfg)
        return adamw.adamw_update(p, grads, s, cfg)

    def same(a, b):
        for x, y in zip(store.flatten(a[0]) + store.flatten(a[1]),
                        store.flatten(b[0]) + store.flatten(b[1])):
            assert torch.equal(x, y)
        assert float(b[2]["grad_norm"]) == pytest.approx(
            float(a[2]["grad_norm"]), rel=1e-6)

    cfg = adamw.OptConfig(warmup_steps=1, total_steps=3)
    params, grads = _t(_tree(1)), _t(_tree(2))
    same(update(cfg, adamw.SLICE_BYTES), update(cfg, 64))
    assert len(list(adamw._slices(params["w"]))) == 3
    loose = dataclasses.replace(cfg, grad_clip=1e9)
    same(update(loose, adamw.SLICE_BYTES), update(loose, 1024))
    # a layer of w is 512 bytes in f32: two a run at 1,024
    assert list(adamw._slices(params["w"])) == [slice(0, 2), slice(2, 4)]


@pytest.mark.parametrize("warm,total", [(1, 4), (100, 10_000), (5, 5)])
def test_cosine_lr_matches_jax(warm, total):
    jcfg = jadamw.OptConfig(warmup_steps=warm, total_steps=total)
    tcfg = adamw.OptConfig(warmup_steps=warm, total_steps=total)
    for step in (0, 1, warm // 2, warm, warm + 1, (warm + total) // 2,
                 total, total + 7):
        want = float(jadamw.cosine_lr(jcfg, jnp.asarray(step, jnp.int32)))
        got = adamw.cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(3)
    jg, jn = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    tg, tn = adamw.clip_by_global_norm(_t(grads), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(adamw.global_norm(_t(grads))) == pytest.approx(
        float(jadamw.global_norm(grads)), rel=1e-6)
    for g, w in zip(adamw.tree_leaves(tg), _leaves(jg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    if max_norm > float(jn):
        for g, w in zip(adamw.tree_leaves(tg), adamw.tree_leaves(_t(grads))):
            assert torch.equal(g, w)


def test_compress_grads_bit_equal_to_jax():
    """int8 ``q`` and f32 ``scale`` bit-equal to JAX's, with and without
    an error-feedback carry; the residual within 1e-9 (of grads of
    ~1e-2) and the dequantized grads bit-equal."""
    grads = _tree(4, scale=0.01)
    error = _tree(5, scale=1e-4)
    for err in (None, error):
        jq, je = jadamw.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, grads),
            None if err is None else jax.tree_util.tree_map(jnp.asarray, err))
        tq, te = adamw.compress_grads(_t(grads),
                                      None if err is None else _t(err))
        for got, want in zip(store.flatten(tq), _leaves(jq)):
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
        assert tq["w"]["q"].dtype == torch.int8
        for got, want in zip(adamw.tree_leaves(te), _leaves(je)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
        for got, want in zip(adamw.tree_leaves(adamw.decompress_grads(tq)),
                             _leaves(jadamw.decompress_grads(jq))):
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_slice", [None, slice(0, 2), slice(3, 8),
                                        slice(1, 8, 3)])
def test_batch_at_host_slice_matches_jax(host_slice):
    cfg = dict(vocab=300, seq_len=33, global_batch=8, seed=9)
    j, t = JSyntheticLM(JDataConfig(**cfg)), SyntheticLM(DataConfig(**cfg))
    for step in (0, 5):
        jb = j.batch_at(step, host_slice)
        tb = t.batch_at(step, host_slice)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(tb[k], jb[k])
    whole = t.batch_at(5)
    if host_slice is not None:
        np.testing.assert_array_equal(t.batch_at(5, host_slice)["tokens"],
                                      whole["tokens"][host_slice])


def test_iter_batches_and_shard_batch():
    cfg = DataConfig(vocab=64, seq_len=9, global_batch=3, seed=2)
    t, j = SyntheticLM(cfg), JSyntheticLM(JDataConfig(**vars(cfg)))
    it, jit_ = t.iter_batches(4), j.iter_batches(4)
    for step in (4, 5, 6):
        b, jb = next(it), next(jit_)
        np.testing.assert_array_equal(b["tokens"], t.batch_at(step)["tokens"])
        np.testing.assert_array_equal(b["targets"], jb["targets"])
    placed = shard_batch(t.batch_at(0), torch.device("cpu"))
    assert set(placed) == {"tokens", "targets"}
    assert placed["tokens"].dtype == torch.int32
    assert placed["tokens"].shape == (3, 9)
    np.testing.assert_array_equal(placed["targets"].numpy(),
                                  t.batch_at(0)["targets"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _train_states(seed=0):
    """A JAX TrainState (bf16 moments, a nonzero step) and its port
    twin."""
    params = jax.tree_util.tree_map(jnp.asarray, _tree(seed))
    opt = jadamw.init_opt_state(params, jadamw.OptConfig())
    rng = np.random.default_rng(seed + 1)
    opt = jadamw.OptState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree_util.tree_map(lambda m: jnp.asarray(
            rng.standard_normal(m.shape), jnp.bfloat16), opt.mu),
        nu=jax.tree_util.tree_map(lambda m: jnp.asarray(
            rng.random(m.shape), jnp.bfloat16), opt.nu))
    js = JS.TrainState(params, opt)
    return js, convert_train_state(jax.tree_util.tree_map(np.asarray, js))


def test_flatten_order_is_jax_leaf_order():
    """NamedTuple fields in field order, dicts by sorted key: the port's
    ``flatten`` of a TrainState is JAX's ``tree_leaves`` of its twin, and
    ``unflatten`` rebuilds the NamedTuples."""
    js, ts = _train_states(1)
    got, want = store.flatten(ts), jax.tree_util.tree_leaves(js)
    assert len(got) == len(want) == 3 * 4 + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    back = store.unflatten(ts, got)
    assert type(back) is TS.TrainState and type(back.opt) is adamw.OptState
    assert back.opt.step is ts.opt.step


def test_port_train_checkpoint_restores_in_jax(tmp_path):
    js, ts = _train_states(2)
    store.save(str(tmp_path), ts, 7)
    got = jstore.restore(str(tmp_path), 7, js)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(js)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_jax_train_checkpoint_restores_in_port(tmp_path):
    js, ts = _train_states(3)
    jstore.save(str(tmp_path), js, 11)
    like = TS.TrainState(
        adamw.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                       ts.params),
        ts.opt)
    got = store.restore(str(tmp_path), 11, like)
    assert type(got) is TS.TrainState and type(got.opt) is adamw.OptState
    assert got.opt.step.dtype == torch.int32 and got.opt.step.ndim == 0
    assert int(got.opt.step) == 11 - 4
    for g, w in zip(store.flatten(got), store.flatten(ts)):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    back = train_state_to_numpy(got)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_prune_keeps_newest(tmp_path):
    tree = {"a": torch.ones(2)}
    for step in (1, 5, 3, 9, 7):
        store.save(str(tmp_path), tree, step)
    (tmp_path / "notes").mkdir()
    store.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == [
        "notes", "step_000000007", "step_000000009"]
    jstore.save(str(tmp_path), {"a": np.ones(2, np.float32)}, 12)
    store.prune(str(tmp_path), keep=0)
    assert sorted(os.listdir(tmp_path)) == ["notes"]
    store.prune(str(tmp_path / "missing"))


def test_async_writer_copies_at_submit(tmp_path):
    """``submit`` copies the tree to new host tensors before it returns:
    an in-place update after it does not reach the checkpoint; writes
    prune to ``keep``; ``close`` drains; a failed write surfaces."""
    js, ts = _train_states(4)
    w = store.AsyncWriter(str(tmp_path), keep=2)
    want = [t.clone() for t in store.flatten(ts)]
    for step in (1, 2, 3):
        w.submit(ts, step)
        for t in store.flatten(ts.params):
            t.add_(1.0)                      # the loop's in-place update
    w.close()
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]
    got = store.restore(str(tmp_path), 2, ts)
    for g, x in zip(store.flatten(got.params), want):
        assert torch.equal(g, x + 1.0)
    man = json.loads((tmp_path / "step_000000003" / "manifest.json")
                     .read_text())
    assert man["status"] == "complete" and man["n_leaves"] == 13
    bad = store.AsyncWriter(str(tmp_path / "file"), keep=1)
    (tmp_path / "file").write_text("not a directory")
    bad.submit({"a": torch.ones(1)}, 1)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        bad.close()

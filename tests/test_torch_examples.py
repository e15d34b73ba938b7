"""The port's examples (``examples/*_torch.py``) at a small size on the
CPU, against the JAX functions their JAX twins call, on the same numpy
inputs and params (carried across by ``repro_torch.convert``).

Tolerances, stated per quantity:
  * quickstart: the sparsities, Eq. 1 compression, Eq. 2 ops reduction
    and the skipped-tile share equal (integer counts through the same
    f32 formulas); the dual pass equal bit for bit to JAX's plain
    ``quant_matmul_ref``; the cost model's cycles and energy within
    1e-9 relative;
  * calibrate_and_serve, run at f32 (at bf16 XLA keeps excess precision
    in its fused forward pass: a quarter of the smoke config's int8
    hidden stream then sits one step from the port's): the global
    sweep's chosen (l, h) and every
    candidate's sparsity equal, each candidate's error within 1e-6
    relative (an f32 mean summed in another order), Algorithm 1's
    learned (l, h) within 1e-4; the served tokens equal to JAX's
    ``make_serve_prefill``/``make_serve_decode`` on JAX's quantization
    of the same float params at the learned constants; the int8 hidden
    stream q8 equal to JAX's ``forward_hidden`` of the same params;
  * train_with_failover: one restart, the restored params bit-equal, the
    first loss within 1e-5 relative of JAX's first step on the same
    params and batch (f32, as ``test_torch_train.py`` holds the step).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "calibrate_and_serve_torch",
                                  "train_with_failover_torch"])
def test_example_refuses_cuda_without_a_card(name):
    """--device defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _load(name).main([])


def test_quickstart_matches_jax():
    from repro.core import costmodel as JCM
    from repro.core.clipping import (apply_clipping,
                                     importance_mask_tile_aligned)
    from repro.core.quantize import quantize_activations, quantize_weights
    from repro.core.sparqle import (compression_percent, encode,
                                    ops_reduction_percent,
                                    subprecision_sparsity, tile_population)
    from repro.kernels.ref import quant_matmul_ref
    ex = _load("quickstart_torch")
    got = ex.main(["--device", "cpu", "--m", "64", "--k", "512", "--n",
                   "64"])
    x, w = ex.make_inputs(64, 512, 64, 0)
    qa = quantize_activations(jnp.asarray(x), bits=8, per_token=True)
    qw = quantize_weights(jnp.asarray(w), bits=4, axis=0)
    s0 = float(subprecision_sparsity(qa.q))
    mask = importance_mask_tile_aligned(jnp.asarray(w), 50.0, tile_k=128)
    q_clip = apply_clipping(qa.q, mask, l=-128, h=127)
    s1 = float(subprecision_sparsity(q_clip))
    assert got["s0"] == s0 and got["s1"] == s1
    assert got["compression"] == float(compression_percent(s0))
    assert got["ops_reduction"] == float(ops_reduction_percent(s0))
    # the skip tiles of the port's kernel: 16 rows x 128 columns
    pop = tile_population(encode(q_clip).pbm, 16, 128)
    assert got["skipped"] == float((pop == 0).astype(jnp.float32).mean())
    assert 0.0 < got["skipped"] < 1.0 and got["exact"]
    dense = quant_matmul_ref(q_clip, qw.q, qa.scale.reshape(-1, 1),
                             qw.scale.reshape(1, -1))
    np.testing.assert_array_equal(_np(got["out"]), np.asarray(dense))
    hw = JCM.HardwareConfig()
    shape = JCM.LinearShape("demo", *ex.COST_SHAPE, w_bits=4, s=s1)
    want = [JCM.linear_cost(shape, hw, sparqle=s) for s in (False, True)]
    for mine, ref in zip(got["cycles"], want):
        assert abs(mine - ref.cycles) <= 1e-9 * abs(ref.cycles)
    for mine, ref in zip(got["energy_pj"], want):
        assert abs(mine - ref.energy_pj) <= 1e-9 * abs(ref.energy_pj)


@pytest.fixture(scope="module")
def calibrated():
    return _load("calibrate_and_serve_torch").main(["--device", "cpu",
                                                    "--dtype", "float32"])


def test_calibration_matches_jax(calibrated):
    """The sweep and Algorithm 1 through JAX's functions on the port's
    calibration stream, and that stream against JAX's forward pass."""
    from repro.core.clipping import (apply_clipping, global_calibrate,
                                     importance_mask_tile_aligned,
                                     init_clip_params,
                                     learn_clipping_constants,
                                     soft_clipping)
    from repro.core.quantize import quantize_activations
    from repro.core.sparqle import subprecision_sparsity
    from repro.models import model as JM
    from repro.models.registry import get_config as jget_config
    from repro_torch.convert import to_numpy_tree
    ex = _load("calibrate_and_serve_torch")
    r = calibrated
    q8 = jnp.asarray(_np(r["q8"]))
    jparams = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(r["params"]))
    w0 = jparams["stages"]["s0"]["p0"]["w_gate"][0]
    mask = importance_mask_tile_aligned(w0, 50.0, 16)
    np.testing.assert_array_equal(_np(r["mask"]), np.asarray(mask))
    seen = []

    def eval_fn(l, h):
        qc = apply_clipping(q8, mask, l, h)
        mse = float(jnp.mean((qc - q8).astype(jnp.float32) ** 2))
        sp = float(subprecision_sparsity(qc))
        seen.append((l, h, mse, sp))
        return mse, sp

    best = global_calibrate(eval_fn)
    assert (r["best"].l, r["best"].h) == (best.l, best.h)
    assert r["best"].sparsity == best.sparsity
    assert len(r["candidates"]) == len(seen) == 36
    for (l, h, mse, sp), (jl, jh, jmse, jsp) in zip(r["candidates"], seen):
        assert (l, h, sp) == (jl, jh, jsp)
        assert abs(mse - jmse) <= 1e-6 * max(abs(jmse), 1e-30)
    maskf = mask.astype(jnp.float32)

    def apply_clip(cp, batch):
        y, m = soft_clipping(batch, maskf, cp["l"][0], cp["h"][0], tau=4.0)
        return y * 0.01, jnp.mean(m)

    cp, _ = learn_clipping_constants(
        apply_clip, lambda b: b.astype(jnp.float32) * 0.01,
        q8.reshape(ex.CAL_BATCH, -1, q8.shape[-1]),
        init_clip_params(1, l0=float(best.l), h0=float(best.h)),
        epochs=ex.EPOCHS, lr=1.0, alpha=0.5)
    assert abs(r["clip"][0] - float(cp["l"][0])) <= 1e-4
    assert abs(r["clip"][1] - float(cp["h"][0])) <= 1e-4
    # the calibration stream itself: JAX's forward pass of the same params
    from repro.data.pipeline import DataConfig, SyntheticLM
    jc = jget_config("granite-8b", smoke=True).replace(dtype="float32")
    data = SyntheticLM(DataConfig(vocab=jc.vocab, seq_len=ex.CAL_SEQ,
                                  global_batch=ex.CAL_BATCH))
    hidden = JM.forward_hidden(jc, jparams,
                               {"tokens": jnp.asarray(data.batch_at(0)[
                                   "tokens"])})
    jq8 = quantize_activations(hidden.reshape(-1, hidden.shape[-1]),
                               bits=8, per_token=True).q
    np.testing.assert_array_equal(np.asarray(jq8), np.asarray(q8))


def test_served_tokens_match_jax(calibrated):
    from repro.core.qlinear import quantize_model_params
    from repro.launch import steps as JS
    from repro.models.registry import get_config as jget_config
    from repro_torch.convert import to_numpy_tree
    ex = _load("calibrate_and_serve_torch")
    r = calibrated
    jc = jget_config("granite-8b", smoke=True).replace(dtype="float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(r["params"]))
    qparams = quantize_model_params(jparams, w_bits=jc.w_bits, k_percent=50.0,
                                    clip_l=r["clip"][0], clip_h=r["clip"][1],
                                    tile_k=16)
    from repro.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=jc.vocab, seq_len=ex.CAL_SEQ,
                                  global_batch=ex.CAL_BATCH))
    prompts = jnp.asarray(data.batch_at(7)["tokens"])[:ex.B, :ex.P]
    prefill = jax.jit(JS.make_serve_prefill(jc, ex.P + ex.GEN))
    decode = jax.jit(JS.make_serve_decode(jc))
    tok, cache = prefill(qparams, {"tokens": prompts})
    outs = [tok]
    for i in range(ex.GEN - 1):
        tok, cache = decode(qparams, cache, tok,
                            jnp.full((ex.B,), ex.P + i, jnp.int32))
        outs.append(tok)
    want = np.asarray(jnp.stack(outs, 1)).tolist()
    assert r["tokens"] == want
    assert all(0 <= t < jc.vocab for row in want for t in row)


def test_failover_matches_jax():
    from repro.configs.base import ModelConfig as JConfig
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import steps as JS
    from repro.optim.adamw import OptConfig, init_opt_state
    from repro_torch.convert import to_numpy_tree
    from repro_torch.models.schema import init_params
    from repro_torch.models.schema_builder import build_schema
    ex = _load("train_with_failover_torch")
    argv = ["--device", "cpu", "--steps", "6", "--d-model", "64",
            "--layers", "2", "--seq", "32", "--batch", "4", "--dtype",
            "float32"]
    got = ex.main(argv)
    assert got["report"].restarts == 1 and got["report"].faults_seen == 1
    assert got["restored_equal"] and got["restored_step"] == 6
    # replayed from the step-0 checkpoint: 6 steps + the 3 before the fault
    assert len(got["losses"]) == 9 and got["losses"][:3] == got["losses"][3:6]
    cfg = ex.demo_config(64, 2, "float32")
    params = init_params(build_schema(cfg), 0, "cpu")
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "dtype")})
    jparams = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(params))
    ocfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=6)
    step = jax.jit(JS.make_train_step(jcfg, ocfg, JS.TrainKnobs(
        microbatch=2, ce_chunk=64)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    _, m = step(JS.TrainState(jparams, init_opt_state(jparams, ocfg)),
                {k: jnp.asarray(v) for k, v in data.batch_at(0).items()})
    want = float(m["loss"])
    assert abs(got["losses"][0] - want) <= 1e-5 * abs(want)

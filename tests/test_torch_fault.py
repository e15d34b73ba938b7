"""Port parity, the restartable loop and the training entry point
(``distributed/fault.py``, ``launch/train.py``), and the port's own
system test (the twin of ``tests/test_system.py``): train, checkpoint,
fault, restore, quantize, serve.

The loop against JAX's ``RestartableLoop`` on the same counter step and
fault plans: the same reports, checkpoints and final state, and the
``fault_*`` metrics under the same names and units. A faulted train run
equals a clean one bit for bit (``torch.equal``: the CPU's ops are
deterministic, the batches a pure function of the step). The system
test's floors are the reference's: the loss falls by >= 0.5 over 200
steps, greedy agreement of the quantized and float models >= 0.5, MSB4
sparsity of the trained activations > 0.08.
"""
import numpy as np
import pytest
import torch

from repro.distributed import fault as jfault
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.qlinear import quantize_model_params
from repro_torch.core.quantize import quantize_activations
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.distributed import fault
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim.adamw import OptConfig

CPU = torch.device("cpu")


def _counter_step(state, batch):
    """A deterministic step on a dict of one f32 vector."""
    x = state["x"] * 0.5 + batch
    return {"x": x}, {"loss": x.sum()}


def _run_loop(mod, ckdir, plan, to, *, max_restarts=10, registry=None,
              deadline_s=1e9, hang_s=0.5, async_ckpt=False):
    injector = mod.FaultInjector(plan=dict(plan), hang_s=hang_s)
    loop = mod.RestartableLoop(
        lambda s, b: (lambda o: ({"x": to(o[0]["x"])}, o[1]))(
            _counter_step({"x": torch.as_tensor(np.array(s["x"]))},
                          torch.as_tensor(np.asarray(b)))),
        lambda i: np.full(4, float(i), np.float32), str(ckdir),
        ckpt_every=3, injector=injector, max_restarts=max_restarts,
        deadline_s=deadline_s, async_ckpt=async_ckpt, registry=registry)
    state, _ = loop.run({"x": to(torch.zeros(4))}, 0, 10)
    return np.asarray(state["x"]), loop.report


@pytest.mark.parametrize("plan", [{}, {4: "fail"}, {0: "fail", 7: "fail"},
                                  {5: "fail", 6: "fail"}])
def test_loop_matches_jax(tmp_path, plan):
    """The same counter step and fault plan through both loops: the same
    final state, report and complete checkpoints."""
    import jax.numpy as jnp
    got, rep = _run_loop(fault, tmp_path / "t", plan, lambda t: t)
    want, jrep = _run_loop(jfault, tmp_path / "j", plan,
                           lambda t: jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(got, want)
    assert vars(rep) == vars(jrep)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_restart_budget_raises(tmp_path):
    plan = {i: "fail" for i in range(10)}
    with pytest.raises(RuntimeError, match="restart budget"):
        _run_loop(fault, tmp_path, plan, lambda t: t, max_restarts=2)


def test_straggler_deadline_restores(tmp_path):
    """A 'hang' step past the deadline trips ``StragglerTimeout`` after
    it, which restores and replays as a fault does."""
    got, rep = _run_loop(fault, tmp_path / "a", {5: "hang"}, lambda t: t,
                         deadline_s=0.05, hang_s=0.1)
    clean, _ = _run_loop(fault, tmp_path / "b", {}, lambda t: t)
    np.testing.assert_array_equal(got, clean)
    assert rep.faults_seen == rep.restarts == rep.restores == 1
    mon = fault.DeadlineMonitor(1e9)
    mon.begin()
    mon.end()
    mon.raise_if_tripped()


def test_fault_metrics_match_jax_names_and_units(tmp_path):
    """The registry mirror: the reference's ``fault_*`` names, kinds and
    units, and the same counts for the same run."""
    import jax.numpy as jnp
    reg, jreg = MetricsRegistry(), JRegistry()
    _run_loop(fault, tmp_path / "t", {4: "fail"}, lambda t: t, registry=reg)
    _run_loop(jfault, tmp_path / "j", {4: "fail"},
              lambda t: jnp.asarray(t.numpy()), registry=jreg)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert sorted(snap) == sorted(jsnap) == [
        "fault_checkpoints_total", "fault_faults_total",
        "fault_restarts_total", "fault_restores_total",
        "fault_steps_run_total", "fault_time_lost_seconds"]
    for name in snap:
        assert (snap[name]["type"], snap[name]["unit"]) == (
            jsnap[name]["type"], jsnap[name]["unit"])
        if name != "fault_time_lost_seconds":
            assert snap[name]["series"] == jsnap[name]["series"]
    assert snap["fault_time_lost_seconds"]["series"][0]["value"] > 0


def _granite_tiny():
    return get_config("granite-8b", smoke=True).replace(dtype="float32")


def _train_run(ckdir, injector, async_ckpt=False):
    cfg = _granite_tiny()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4, seed=1))
    ocfg = OptConfig(lr=2e-3, warmup_steps=2, total_steps=20)
    step = S.make_train_step(cfg, ocfg, S.TrainKnobs(ce_chunk=8))
    state = train.build_state(cfg, ocfg, 1, CPU)
    loop = fault.RestartableLoop(
        step, lambda i: shard_batch(data.batch_at(i), CPU), str(ckdir),
        ckpt_every=5, injector=injector, async_ckpt=async_ckpt)
    state, _ = loop.run(state, 0, 12)
    return state, loop


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_train_with_fault_recovery_matches_clean_run(tmp_path, async_ckpt):
    """A train run with an injected failure at step 8 (restored from step
    5's checkpoint, sync or async) ends with the clean run's state, bit
    for bit; its final checkpoint restores to that state."""
    clean, _ = _train_run(tmp_path / "clean", None)
    faulted, loop = _train_run(tmp_path / "fault",
                               fault.FaultInjector(plan={8: "fail"}),
                               async_ckpt)
    assert loop.report.restarts == 1 and loop.report.steps_run == 15
    for a, b in zip(store.flatten(clean), store.flatten(faulted)):
        assert torch.equal(a, b)
    final = store.restore(str(tmp_path / "fault"), 12, clean)
    assert int(final.opt.step) == 12
    for a, b in zip(store.flatten(final), store.flatten(clean)):
        assert torch.equal(a, b)


def test_train_cli_recovers(tmp_path, capsys):
    """``launch/train.main`` on the granite smoke config on the CPU, 12
    steps with a failure injected at step 8: one restart, a falling loss;
    ``--resume auto`` continues from the final checkpoint."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--ckpt-every", "5", "--ckpt-dir", ck, "--log-every", "4"]
    r = train.main(base + ["--steps", "12", "--inject-fail", "8"])
    out = capsys.readouterr().out
    assert r["report"].restarts == 1 and r["report"].faults_seen == 1
    assert len(r["losses"]) == 15 and all(np.isfinite(r["losses"]))
    assert r["losses"][-1] < r["losses"][0]
    assert "done: LoopReport(steps_run=15, restarts=1" in out
    assert f"final loss {r['losses'][-1]:.4f} (first {r['losses'][0]:.4f})" \
        in out
    assert store.latest_step(ck) == 12
    r2 = train.main(base + ["--steps", "3", "--resume", "auto"])
    assert "resumed from step 12" in capsys.readouterr().out
    assert r2["start"] == 12 and store.latest_step(ck) == 15
    assert int(r2["state"].opt.step) == 15


def test_train_cli_refusals():
    """The reference's refusals, and the port's: a frontend stub arch
    (encoder, VLM) from the CLI; the meshes it cannot shard, before any
    rank starts (starcoder2's 2 KV heads over 4 model ranks; mamba2's 8
    SSD heads over 3); the card when there is none."""
    for arch in ("hubert-xlarge", "paligemma-3b"):
        with pytest.raises(SystemExit, match="non-LM"):
            train.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="n_kv_heads"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
                    "--model-axis", "4"])
    with pytest.raises(ValueError, match="SSD heads"):
        train.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                    "--model-axis", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# the system: train -> quantize -> serve (tests/test_system.py's contract)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The granite smoke model (vocab 256) trained 200 steps on the
    synthetic stream, as the reference's system test trains it."""
    cfg = get_config("granite-8b", smoke=True).replace(vocab=256)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8, seed=3))
    ocfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=200)
    step = S.make_train_step(cfg, ocfg, S.TrainKnobs(microbatch=4,
                                                     ce_chunk=32))
    state = train.build_state(cfg, ocfg, 0, CPU)
    losses = []
    for i in range(200):
        state, m = step(state, shard_batch(data.batch_at(i), CPU))
        losses.append(float(m["loss"]))
    return cfg, data, state, losses


def test_training_learns(trained):
    _, _, _, losses = trained
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_quantized_serving_of_trained_model(trained):
    """The paper's deployment: the trained tree quantized W4A8 with
    clipping decodes greedily close to the float model, and the trained
    activations show sub-precision sparsity."""
    cfg, data, state, _ = trained
    params = state.params
    qparams = quantize_model_params(params, w_bits=4, k_percent=50.0,
                                    tile_k=16)
    b, p, gen = 2, 32, 6
    prompts = torch.from_numpy(data.batch_at(500)["tokens"][:b, :p])

    def decode_n(tree):
        tok, cache = S.make_serve_prefill(cfg, p + gen)(
            tree, {"tokens": prompts})
        outs = [tok]
        for i in range(gen - 1):
            tok, cache = S.make_serve_decode(cfg)(
                tree, cache, tok, torch.full((b,), p + i, dtype=torch.int32))
            outs.append(tok)
        return torch.stack(outs, 1)

    agree = float((decode_n(params) == decode_n(qparams)).float().mean())
    assert agree >= 0.5, f"greedy agreement {agree} too low"
    with torch.no_grad():
        hidden = M.forward_hidden(cfg, params, {"tokens": prompts})
    q8 = quantize_activations(hidden.reshape(-1, hidden.shape[-1]), bits=8,
                              per_token=True).q
    s = float(subprecision_sparsity(q8))
    assert s > 0.08, f"trained activations should be MSB4-sparse, got {s}"


def test_checkpoint_roundtrip_full_state(tmp_path, trained):
    _, _, state, _ = trained
    store.save(str(tmp_path), state, 42)
    restored = store.restore(str(tmp_path), 42, state)
    assert type(restored) is type(state)
    for a, b in zip(store.flatten(state), store.flatten(restored)):
        assert torch.equal(a, b)

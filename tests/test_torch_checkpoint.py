"""Port parity, checkpoints and the serve CLI's inputs: the npz+manifest
store both ways (JAX's ``store.save`` -> the port's ``restore``, the
port's ``save`` -> JAX's ``restore``), bf16 leaves included and read
without ``ml_dtypes``; ``latest_step`` skipping an incomplete manifest;
``SyntheticLM`` batches equal to JAX's; and ``serve --ckpt DIR --device
cpu`` giving the greedy streams of JAX's serve of the same checkpoint,
for every architecture the engine serves.

The CLI comparison runs both serves on the smoke configs at f32 (the
configs' lookup patched in both CLIs): at bf16 XLA's jitted steps keep
excess f32 precision across fused ops (``tests/test_torch_zoo.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import store
from repro_torch.convert import convert_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import serve
from repro_torch.models.schema import abstract_params
from repro_torch.models.schema_builder import build_schema as tschema
from test_torch_zoo import tconfig

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-8b", "yi-6b", "starcoder2-3b", "deepseek-moe-16b")


def _mixed_tree(seed):
    """Nested dicts (keys inserted out of order) of f32, bf16, int8,
    int32 and bool leaves, as numpy."""
    rng = np.random.default_rng(seed)
    bf = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    return {"z": {"b": rng.standard_normal((4, 2)).astype(np.float32),
                  "a": np.asarray(bf)},
            "m": rng.integers(-128, 127, (6,), dtype=np.int8),
            "a": {"y": np.arange(5, dtype=np.int32),
                  "x": rng.integers(0, 2, (2, 3)).astype(bool)}}


def _assert_tree_equal(got, want):
    """``got``: a torch tree; ``want``: a numpy/jax tree (bf16 compared
    through f32)."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_tree_equal(got[k], want[k])
        return
    w = np.asarray(want)
    if w.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      w.astype(np.float32))
    else:
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


def test_jax_save_port_restore(tmp_path):
    tree = _mixed_tree(0)
    jstore.save(str(tmp_path), tree, 7)
    like = convert_tree(tree)
    got = store.restore(str(tmp_path), 7, like)
    _assert_tree_equal(got, tree)
    assert store.flatten(got)[0] is not store.flatten(like)[0]


def test_port_save_jax_restore(tmp_path):
    tree = _mixed_tree(1)
    store.save(str(tmp_path), convert_tree(tree), 3, shard_bytes=40)
    man = json.loads((tmp_path / "step_000000003" / "manifest.json")
                     .read_text())
    assert man["n_leaves"] == 5 and len(man["shards"]) > 1
    got = jstore.restore(str(tmp_path), 3,
                         jax.tree_util.tree_map(jnp.asarray, tree))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a).astype(np.float32), np.asarray(b).astype(
                np.float32)), got, tree)
    assert np.asarray(got["z"]["a"]).dtype == jnp.bfloat16


def test_restore_reads_bf16_without_ml_dtypes(tmp_path):
    """A process in which ``import ml_dtypes`` fails restores JAX's bf16
    leaf bit for bit."""
    x = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    jstore.save(str(tmp_path), {"w": x}, 1)
    bits = np.asarray(x).view(np.uint16).tolist()
    code = (
        "import sys, torch; sys.modules['ml_dtypes'] = None\n"
        "from repro_torch.checkpoint import store\n"
        f"like = {{'w': torch.empty((3, 4), dtype=torch.bfloat16)}}\n"
        f"t = store.restore({str(tmp_path)!r}, 1, like)['w']\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if "
        "sys.modules[m] is not None]\n"
        "print(t.view(torch.int16).numpy().view('uint16').tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == bits


def test_latest_step_skips_incomplete_and_restore_checks(tmp_path):
    tree = {"a": np.ones((2, 2), np.float32)}
    store.save(str(tmp_path), convert_tree(tree), 5)
    jstore.save(str(tmp_path), tree, 9)
    man = tmp_path / "step_000000009" / "manifest.json"
    m = json.loads(man.read_text())
    m["status"] = "writing"
    man.write_text(json.dumps(m))
    (tmp_path / "step_000000011").mkdir()              # no manifest
    (tmp_path / "step_000000012").mkdir()
    (tmp_path / "step_000000012" / "manifest.json").write_text("{")
    (tmp_path / "notes").mkdir()
    assert store.latest_step(str(tmp_path)) == 5 == jstore.latest_step(
        str(tmp_path))
    assert store.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="incomplete"):
        store.restore(str(tmp_path), 9, convert_tree(tree))
    with pytest.raises(ValueError, match="leaves"):
        store.restore(str(tmp_path), 5, {"a": torch.empty(2, 2),
                                         "b": torch.empty(1)})
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 5, {"a": torch.empty(2, 3)})


@pytest.mark.parametrize("cfg", [dict(), dict(vocab=64000, seq_len=37,
                                              global_batch=3, seed=5)])
def test_synthetic_batches_match_jax(cfg):
    j, t = JSyntheticLM(JDataConfig(**cfg)), SyntheticLM(DataConfig(**cfg))
    for step in (0, 3):
        jb, tb = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_ckpt_streams_match_jax_serve(arch, tmp_path, monkeypatch):
    """JAX's ``store.save`` writes the float params of ``arch``'s smoke
    config (f32); JAX's ``serve --ckpt`` and the port's ``serve --ckpt
    --device cpu`` (restore, quantize one layer at a time, SyntheticLM
    prompts) emit the same greedy streams. The port's restore fills the
    schema's layout (meta tensors) in JAX's flatten order."""
    f32 = lambda name, smoke=False: jregistry.get_config(  # noqa: E731
        name, smoke).replace(dtype="float32")
    monkeypatch.setattr(jserve, "get_config", f32)
    monkeypatch.setattr(serve, "get_config", lambda name, smoke=False:
                        tconfig(f32(name, smoke)))
    jc = f32(arch, True)
    params = jinit(jschema(jc), jax.random.PRNGKey(11))
    jstore.save(str(tmp_path), {"params": params}, 4)
    like = {"params": abstract_params(tschema(tconfig(jc)))}
    restored = store.restore(str(tmp_path), 4, like)["params"]
    assert torch.equal(restored["embed"]["table"],
                       torch.from_numpy(np.array(params["embed"]["table"])))

    handles = []
    submit = JEngine.submit
    monkeypatch.setattr(JEngine, "submit", lambda self, *a, **k: (
        handles.append(submit(self, *a, **k)) or handles[-1]))
    argv = ["--arch", arch, "--smoke", "--ckpt", str(tmp_path), "--batch",
            "3", "--prompt-len", "12", "--gen", "4", "--page-size", "8",
            "--seed", "2"]
    jserve.main(argv)
    r = serve.main(argv + ["--device", "cpu"])
    assert r["streams"] == [list(h.out_tokens) for h in handles]
    assert [len(s) for s in r["streams"]] == [4, 4, 4]
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt",
                    str(tmp_path / "none")])


def test_serve_prompts_are_jax_serve_prompts():
    cfg = tconfig(jregistry.get_config("yi-6b", True))
    want = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=20,
                                    global_batch=3, seed=4)).batch_at(0)
    assert serve.synthetic_prompts(cfg, 4, 3, 20) == want["tokens"].tolist()

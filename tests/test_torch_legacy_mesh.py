"""The ``--legacy`` steps on a (data, model) mesh against JAX's one-device
steps: granite-8b (GQA), gemma3-27b (sliding windows), deepseek-v3-671b
(MLA, MoE), mamba2-2.7b (SSD), jamba-v0.1-52b (hybrid) and hubert-xlarge
(an encoder: prefill only), smoke configs in f32, at 1x2, 2x2 and 2x1
with one sequence (the cache cut along its positions over data): prefill
and GEN greedy decode steps agree with JAX's ``prefill``/``decode_step``
under ``tests/test_torch_zoo.py``'s bounds, every rank's rows; at 2x1
with the batch split over data, bit for bit with the port's one-device
steps. The ranks run in worlds of 2 and 4 (``tests/_torch_worlds.py``
``legacy_mesh_world``), spawned in a thread while JAX computes."""
from __future__ import annotations

import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import (deepseek_v3_671b, gemma3_27b, granite_8b,
                           hubert_xlarge, jamba_v01_52b, mamba2_2p7b)
from repro.core.qlinear import quantize_model_params as jquantize
from repro.models import model as JM
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import model as TM

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_worlds import legacy_mesh_world  # noqa: E402
from test_torch_zoo import LEGACY_ATOL, assert_greedy_agrees  # noqa: E402

JCONFIGS = {
    "granite-8b": granite_8b.SMOKE,
    "gemma3-27b": gemma3_27b.SMOKE,
    "deepseek-v3-671b": deepseek_v3_671b.SMOKE,
    "mamba2-2.7b": mamba2_2p7b.SMOKE,
    "jamba-v0.1-52b": jamba_v01_52b.SMOKE.replace(n_layers=4, attn_every=4),
    "hubert-xlarge": hubert_xlarge.SMOKE,
}
ARCHS = tuple(JCONFIGS)
PROMPT, GEN, MAX_LEN = 20, 8, 32
# assert_greedy_agrees' bound against JAX: LEGACY_ATOL, but jamba's, whose
# one-device port already parts from JAX by up to 1.3e-2 on these inputs
# (an int8 rounding flipped by an f32 ulp before an MoE layer: the mesh
# steps give the one-device port's logits within MESH_TOL)
JAX_ATOL = {"jamba-v0.1-52b": 2e-2}
# the mesh steps against the port's one-device steps: logits within this
# share of their max |logit| (f32 sums in another order: the merged
# attention, a row-cut projection's f32 drain, an MoE's partial sums)
MESH_TOL = 1e-4
# (data, model) and the batch; the last, the batch split over data at
# model 1, is the bit-exact case
CASES = (((1, 2), 2), ((2, 2), 2), ((2, 1), 1))
EXACT = ((2, 1), 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(jc, b, rng):
    if jc.family == "encoder":
        return {"frames": rng.standard_normal(
            (b, PROMPT, jc.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, jc.vocab, (b, PROMPT)).astype(
        np.int32)}


def _greedy(prefill, decode, batch, encoder):
    """(tokens (steps, B), logits (steps, B, V)) of prefill and GEN greedy
    decode steps."""
    logits, cache = prefill(batch)
    toks, steps = [], []
    for i in range(GEN + 1):
        lg = np.asarray(logits, np.float32)
        tok = lg.argmax(-1).astype(np.int32)
        toks.append(tok)
        steps.append(lg)
        if i == GEN or encoder:
            break
        logits, cache = decode(cache, tok, np.full(tok.shape, PROMPT + i,
                                                   np.int32))
    return np.stack(toks), np.stack(steps)


def _jax_run(jc, qp, batch):
    pf = jax.jit(lambda p, bt: JM.prefill(jc, p, bt, max_len=MAX_LEN))
    dc = jax.jit(lambda p, c, t, s: JM.decode_step(jc, p, c, t, s))
    return _greedy(lambda bt: pf(qp, bt),
                   lambda c, t, s: dc(qp, c, t, s), batch,
                   jc.family == "encoder")


def _port_run(tc, tp, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        return _greedy(
            lambda bt: TM.prefill(tc, tp, t, max_len=MAX_LEN),
            lambda c, tok, s: TM.decode_step(tc, tp, c, torch.from_numpy(tok),
                                             torch.from_numpy(s)),
            batch, tc.family == "encoder")


@pytest.fixture(scope="module")
def runs():
    """Per arch: the quantized trees, the batches (B = 2 and 1), JAX's and
    the port's one-device streams, and every mesh case's rank results."""
    models, jobs = {}, []
    for arch, jc0 in JCONFIGS.items():
        jc = jc0.replace(dtype="float32")
        rng = np.random.default_rng(7)
        qp = jax.jit(lambda f, jc=jc: jquantize(
            f, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
            enable_clipping=True, tile_k=16))(
                jinit(jschema(jc), jax.random.PRNGKey(0)))
        tc = ModelConfig(**{f: getattr(jc, f) for f in
                            jc.__dataclass_fields__})
        tp = convert_tree(_np(qp))
        batches = {2: _batch(jc, 2, rng)}
        batches[1] = {k: v[:1] for k, v in batches[2].items()}
        models[arch] = dict(jc=jc, qp=qp, tc=tc, tp=tp, batches=batches)
        for mesh, b in CASES + (EXACT,):
            jobs.append(dict(id=(arch, mesh, b), mesh=mesh, cfg=tc,
                             params=tp, batch=batches[b], gen=GEN,
                             max_len=MAX_LEN))
    mesh_out = {}

    def worlds():
        for world in (2, 4):
            for r in spawn_world(legacy_mesh_world, world, jobs,
                                 timeout_s=120):
                for key, v in r.items():
                    mesh_out.setdefault(key, []).append(v)

    th = threading.Thread(target=worlds)
    th.start()
    ref = {}
    for arch, m in models.items():
        for b in (1, 2):
            ref[(arch, b)] = dict(
                jax=_jax_run(m["jc"], m["qp"], m["batches"][b]),
                port=_port_run(m["tc"], m["tp"], m["batches"][b]))
    th.join()
    return ref, mesh_out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh,b", CASES)
def test_mesh_steps_agree_with_jax(runs, arch, mesh, b):
    """Every rank's rows: the greedy stream and its logits a step against
    JAX's one-device steps, as ``assert_greedy_agrees`` bounds them
    (JAX_ATOL), and against the port's one-device steps: the same
    tokens, logits within MESH_TOL of their max."""
    ref, mesh_out = runs
    jtok, jlog = ref[(arch, b)]["jax"]
    ptok, plog = ref[(arch, b)]["port"]
    ranks = mesh_out[(arch, mesh, b)]
    assert len(ranks) == mesh[0] * mesh[1]
    for first, toks, logits in ranks:
        toks, logits = np.stack(toks), np.stack(logits)
        n = toks.shape[1]
        np.testing.assert_array_equal(toks, ptok[:, first:first + n])
        want = plog[:, first:first + n]
        assert np.abs(logits - want).max() <= MESH_TOL * np.abs(want).max()
        for r in range(n):
            row = first + r
            assert_greedy_agrees(
                (list(jtok[:, row]), list(jlog[:, row])),
                (list(toks[:, r]), list(logits[:, r])),
                atol=JAX_ATOL.get(arch, LEGACY_ATOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_is_the_one_device_step(runs, arch):
    """At (2, 1) with the batch split over data the ranks' rows are the
    port's one-device steps bit for bit: tokens and logits."""
    ref, mesh_out = runs
    ptok, plog = ref[(arch, EXACT[1])]["port"]
    for first, toks, logits in mesh_out[(arch,) + EXACT]:
        toks, logits = np.stack(toks), np.stack(logits)
        n = toks.shape[1]
        np.testing.assert_array_equal(toks, ptok[:, first:first + n])
        np.testing.assert_array_equal(logits, plog[:, first:first + n])

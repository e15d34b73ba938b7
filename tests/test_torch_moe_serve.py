"""Port parity, MoE serving: ``tiny-moe-serve`` (MoE every second layer,
``tests/test_spec_decode.py``) through every serving path against the
JAX package — the engine, the speculative engine (gamma 2, JAX's
counters), dense and packed trees, ``--legacy`` (logits within
``test_torch_zoo.LEGACY_ATOL``, greedy tokens equal up to a near-tie an
f32 ulp flips), the verify window at tight capacity (one routed call a
window position) against decode steps and JAX — and every step kind
through the ``make_fx`` stand-in of a CUDA-graph capture
(``tests/test_torch_graphs.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serving import SamplingParams as JSampling
from repro.serving.kv_pool import PoolConfig as JPoolConfig
from repro.serving.kv_pool import init_pool_state as jinit_pool
from repro_torch.convert import convert_tree
from repro_torch.models import model as TM
from repro_torch.serving import SamplingParams
from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
from test_torch_graphs import FxGraph
from test_torch_moe import CFG_MOE, CPU, TCFG_MOE, _moe_trees
from test_torch_zoo import (GAMMA, assert_greedy_agrees, drive, jax_engine,
                            jax_legacy, port_engine, port_legacy, prompts,
                            tconfig, with_fields)

import chip_smoke


@pytest.fixture(scope="module")
def moe_served():
    qp, tp = _moe_trees("float32")
    reqs = prompts(CFG_MOE.vocab)
    return dict(qp=qp, tp=tp, reqs=reqs,
                jstreams=drive(jax_engine(CFG_MOE, qp), JSampling, reqs))


# ---------------------------------------------------------------------------
# tiny-moe-serve through every serving path
# ---------------------------------------------------------------------------

def test_moe_engine_streams_match_jax(moe_served):
    ts = drive(port_engine(TCFG_MOE, moe_served["tp"]), SamplingParams,
               moe_served["reqs"])
    assert ts == moe_served["jstreams"]


def test_moe_spec_engine_matches_jax_and_base(moe_served):
    te = port_engine(TCFG_MOE, moe_served["tp"], gamma=GAMMA)
    je = jax_engine(CFG_MOE, moe_served["qp"], gamma=GAMMA)
    ts = drive(te, SamplingParams, moe_served["reqs"])
    assert ts == drive(je, JSampling, moe_served["reqs"])
    assert ts == moe_served["jstreams"]
    ja, ta = je.aggregate_stats(), te.aggregate_stats()
    for key in ("spec_acceptance_rate", "spec_tokens_per_step", "steps"):
        assert ta[key] == ja[key], key


@pytest.mark.parametrize("fields", [dict(mode="dense"),
                                    dict(wire_format="packed")],
                         ids=["dense", "packed"])
def test_moe_dense_and_packed_streams_match_jax(moe_served, fields):
    ts = drive(port_engine(TCFG_MOE, with_fields(moe_served["tp"], **fields)),
               SamplingParams, moe_served["reqs"])
    assert ts == moe_served["jstreams"]


def test_moe_legacy_streams_match_jax(moe_served):
    """``--legacy`` routes all B x S prompt tokens in one call (capacity
    from their count) against JAX's jitted ``prefill``/``decode_step``:
    logits within ``LEGACY_ATOL`` a step, greedy tokens equal up to a
    near-tie an f32 ulp flips (the 20-token prompt's first token: JAX's
    logits of the two tokens 4e-3 apart)."""
    for p in moe_served["reqs"]:
        assert_greedy_agrees(jax_legacy(CFG_MOE, moe_served["qp"], p, 5),
                             port_legacy(TCFG_MOE, moe_served["tp"], p, 5))


def test_verify_window_tight_capacity_equals_decode_loop_and_jax():
    """``tests/test_spec_decode.py``'s tight-capacity case on the port:
    the verify window routes one MoE call a window position, so its
    logits and pool equal three decode steps', and its logits JAX's
    window's (within 1e-5, telemetry-free)."""
    jc = CFG_MOE.replace(capacity_factor=0.5)
    tc = tconfig(jc)
    qp, tp = _moe_trees("float32")
    jpool = jinit_pool(jc, JPoolConfig(n_pages=8, page_size=4))
    pool = convert_tree(jax.tree_util.tree_map(np.asarray, jpool))
    bt = np.zeros((2, 6), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    prompt = np.random.RandomState(0).randint(0, jc.vocab, size=5)
    toks = np.pad(prompt[None].astype(np.int32), ((0, 0), (0, 3)))
    jlg, jst, _ = JM.prefill_chunk_paged(
        jc, qp, jpool, jnp.asarray(toks), jnp.asarray(0, jnp.int32),
        jnp.asarray(5, jnp.int32), jnp.asarray(bt[:1]))
    lg, pool, _ = TM.prefill_chunk_paged(tc, tp, pool, torch.from_numpy(toks),
                                         0, 5, torch.from_numpy(bt[:1]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5)
    window = np.asarray([[int(np.argmax(np.asarray(jlg)[0])), 17, 42],
                         [3, 1, 4]], np.int32)
    pos = np.asarray([5, 0], np.int32)
    jvlg, _, _ = JM.verify_window_paged(jc, qp, jst, jnp.asarray(window),
                                        jnp.asarray(pos), jnp.asarray(bt))
    twin = {"stages": {k: {p: {n: t.clone() for n, t in d.items()}
                           for p, d in v.items()}
                       for k, v in pool["stages"].items()}}
    vlg, vpool, _ = TM.verify_window_paged(
        tc, tp, pool, torch.from_numpy(window), torch.from_numpy(pos),
        torch.from_numpy(bt))
    np.testing.assert_allclose(vlg.numpy(), np.asarray(jvlg), atol=1e-5)
    for t in range(3):
        lg1, twin, _ = TM.decode_step_paged(
            tc, tp, twin, torch.from_numpy(window[:, t]),
            torch.from_numpy(pos + t), torch.from_numpy(bt))
        assert torch.equal(vlg[:, t], lg1)
    assert chip_smoke.trees_equal(vpool, twin)


@pytest.mark.parametrize("kind", ["prefill_chunk", "decode", "draft",
                                  "verify", "kv2_decode", "legacy_decode"])
def test_moe_steps_capture(moe_served, kind):
    """Each step kind of ``tiny-moe-serve`` (sort, searchsorted, scatter
    into the capacity buffer, batched expert linears) traced by the
    ``make_fx`` stand-in of a CUDA-graph capture, which refuses a host
    read as a capture does, and replayed at later inputs = eager bits."""
    params = moe_served["tp"]
    case = next(c for c in chip_smoke.graph_cases(
        TCFG_MOE, params, CPU, 0, b=3, ps=4, n_s=6, chunk=8, gamma=2)
        if c[0] == kind)
    assert chip_smoke.replay_vs_eager(CPU, case, graph_type=FxGraph)


def test_moe_pool_matches_jax_layout():
    """The pool of an MoE config stacks the same (stage, period) layers
    as JAX's."""
    jpool = jinit_pool(CFG_MOE, JPoolConfig(n_pages=5, page_size=4))
    tpool = init_pool_state(TCFG_MOE, PoolConfig(n_pages=5, page_size=4),
                            CPU)
    shapes = lambda tree: {  # noqa: E731
        (s, p, n): tuple(v.shape) for s, d in tree["stages"].items()
        for p, e in d.items() for n, v in e.items()}
    assert shapes(tpool) == shapes(jpool)


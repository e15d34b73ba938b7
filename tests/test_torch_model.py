"""Port parity, model: the paged prefill/decode steps of the torch model
against the JAX model on a small f32 config, from the same converted
quantized params and pool.

Tolerances: logits within 1e-4 (attention, RoPE and softmax sum in
other orders); pool nibbles, block-table routing and the telemetry
(wire/dense bytes, sparsity) exact; pool scales within 1e-6 relative (a
K/V row's absmax can move by one ulp through RoPE's cos/sin)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models import layers as jlayers
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving.kv_pool import PoolConfig as JPoolConfig
from repro.serving.kv_pool import init_pool_state as jinit_pool
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree, to_numpy_tree
from repro_torch.core.qlinear import SparqleLinear, quantize_model_params
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serving.kv_pool import PoolConfig, init_pool_state

CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
PS, NPAGES, PMAX, CHUNK = 4, 12, 4, 8


@pytest.fixture(scope="module")
def fparams():
    return jinit(jschema(CFG), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def qparams(fparams):
    return jquantize(fparams, w_bits=4, k_percent=50.0, clip_l=-8.0,
                     clip_h=23.0, enable_clipping=True, tile_k=16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tables(*rows):
    t = np.zeros((len(rows), PMAX), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def test_pool_state_converts_to_port_layout():
    want = init_pool_state(TCFG, PoolConfig(n_pages=NPAGES, page_size=PS))
    got = convert_tree(_np(jinit_pool(
        CFG, JPoolConfig(n_pages=NPAGES, page_size=PS))))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b),
        to_numpy_tree(got), to_numpy_tree(want))


def test_prefill_and_decode_steps_match_jax(qparams):
    rng = np.random.default_rng(0)
    tparams = convert_tree(_np(qparams))
    jpool = jinit_pool(CFG, JPoolConfig(n_pages=NPAGES, page_size=PS))
    tpool = convert_tree(_np(jpool))
    jprefill = jax.jit(JS.make_engine_prefill_chunk(CFG))
    jdecode = jax.jit(JS.make_engine_decode(CFG))
    seq_a = rng.integers(0, CFG.vocab, 10)
    seq_b = rng.integers(0, CFG.vocab, 5)
    table_a, table_b = [3, 7, 1], [5, 2]       # shuffled page ids

    def both_prefill(seq, table, start, n):
        nonlocal jpool
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :n] = seq[start:start + n]
        tbl = _tables(table)
        jl, jpool, jt = jprefill(qparams, jpool, jnp.asarray(toks),
                                 jnp.int32(start), jnp.int32(n),
                                 jnp.asarray(tbl))
        tl, _, tt = TM.prefill_chunk_paged(TCFG, tparams, tpool, _t(toks),
                                           start, n, _t(tbl))
        return (np.asarray(jl), _np(jt)), (tl.numpy(), to_numpy_tree(tt))

    outs = [both_prefill(seq_a, table_a, 0, CHUNK),
            both_prefill(seq_a, table_a, CHUNK, 2),   # second, short chunk
            both_prefill(seq_b, table_b, 0, 5)]
    # decode: A at pos 10, B at pos 5, slot 2 inactive (null page row)
    token = np.array([7, 9, 0], np.int32)
    pos = np.array([10, 5, 0], np.int32)
    tbl = _tables(table_a, table_b, [])
    jl, jpool, jt = jdecode(qparams, jpool, jnp.asarray(token),
                            jnp.asarray(pos), jnp.asarray(tbl))
    tl, _, tt = TM.decode_step_paged(TCFG, tparams, tpool, _t(token),
                                     _t(pos), _t(tbl))
    outs.append(((np.asarray(jl), _np(jt)), (tl.numpy(), to_numpy_tree(tt))))

    for (jlog, jtel), (tlog, ttel) in outs:
        np.testing.assert_allclose(tlog, jlog, atol=1e-4, rtol=1e-4)
        for key in ("layer_wire_bytes", "layer_dense_bytes"):
            np.testing.assert_array_equal(ttel[key], jtel[key])
        for key in ("sparsity", "layer_sparsity"):
            np.testing.assert_array_equal(ttel[key], jtel[key])
        assert jtel["layer_wire_bytes"].shape[0] == CFG.n_layers

    jp = _np(jpool)["stages"]["s0"]["p0"]
    tp = to_numpy_tree(tpool)["stages"]["s0"]["p0"]
    for key in ("k_q", "v_q"):                # page 0 (null) excluded
        np.testing.assert_array_equal(tp[key][:, 1:], jp[key][:, 1:])
    for key in ("k_s", "v_s"):
        np.testing.assert_allclose(tp[key][:, 1:], jp[key][:, 1:],
                                   rtol=1e-6)
    written = np.zeros(NPAGES, bool)
    written[table_a + table_b] = True
    assert (tp["k_q"][:, written] != 0).any()
    assert (tp["k_q"][:, 1:][:, ~written[1:]] == 0).all()


def test_port_quantize_model_params_matches_jax(fparams, qparams):
    tq = quantize_model_params(convert_tree(_np(fparams)), w_bits=4,
                               k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                               tile_k=16)
    conv = convert_tree(_np(qparams))
    names = []
    for name, a in tq["stages"]["s0"]["p0"].items():
        b = conv["stages"]["s0"]["p0"][name]
        if isinstance(a, SparqleLinear):
            names.append(name)
            assert a.packed and b.packed
            for x, y in ((a.w.q, b.w.q), (a.w.scale, b.w.scale),
                         (a.col_mask, b.col_mask), (a.l, b.l), (a.h, b.h)):
                assert torch.equal(x, y), name
    assert sorted(names) == sorted(["wq", "wk", "wv", "wo", "w_gate", "w_up",
                                    "w_down"])


def _t(a):
    return torch.from_numpy(np.array(a))


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    g = rng.standard_normal(8).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(g)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5) + 17
    np.testing.assert_allclose(
        tlayers.rope(_t(x), _t(pos), 10_000.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-5, atol=1e-5)

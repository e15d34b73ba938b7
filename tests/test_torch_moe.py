"""Port parity, the MoE FFN and its expert-batched kernels' plain
versions: the router and the sort-based dispatch against JAX's
``repro.models.moe`` (tight capacity, capacity 1 at decode), the batched
encoder + matmul entries' int32 accumulators against JAX's
``_dual_pass_matmul(batched=True)`` / ``_single_pass_matmul`` bit for
bit, the routed-expert quantization rule, ``tiny-moe-serve`` (MoE every
second layer, ``tests/test_spec_decode.py``; its serving paths are in
``tests/test_torch_moe_serve.py``), and the batched wrappers' one launch
a projection (recorded on the CPU), and the speculative engine under
capacity drops against JAX's (whose streams part from its base
engine's there).

Tolerances: integer work bit-exact; the MoE FFN bit-equal to JAX's eager
ops at bf16 and within rtol 4e-6, atol 1e-6 at f32 (XLA's exp and sums
are not torch's; see ``tests/test_torch_zoo.py``); router weights within
rtol 1e-6 at f32, expert ids equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import qlinear as jql
from repro.core.clipping import apply_clipping as japply_clipping
from repro.core.quantize import quantize_activations as jquantize_act
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.convert import convert_tree, to_tensor
from repro_torch.core import qlinear as tql
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import sparqle_encode as SE
from repro_torch.kernels import sparqle_matmul as SM
from repro_torch.kernels.ref import TILE_K, TILE_M
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro.serving import SamplingParams as JSampling
from repro_torch.serving import SamplingParams
from test_torch_zoo import (GAMMA, drive, jax_engine, port_engine, prompts,
                            quantized, tconfig)

CFG_MOE = JConfig(name="tiny-moe-serve", family="moe", n_layers=4,
                  d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab=64, dtype="float32", n_experts=4, top_k=2,
                  moe_every=2, moe_d_ff=32, router_type="softmax")
TCFG_MOE = tconfig(CFG_MOE)
RTOL, ATOL = 4e-6, 1e-6
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# router and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router_type", ["softmax", "sigmoid"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_router_matches_jax(router_type, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((12, 32)), jnp.float32).astype(dtype)
    w = jnp.asarray(rng.standard_normal((32, 8)) / 6, jnp.float32)
    jv, ji = jmoe.router(x, w, router_type, 3)
    tv, ti = tmoe.router(to_tensor(x), to_tensor(w), router_type, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _moe_trees(dtype):
    """JAX's quantized tree of tiny-moe-serve at ``dtype`` and the port's
    (the capacity factor changes no parameter)."""
    return quantized(CFG_MOE.replace(dtype=dtype))


def _moe_layer(dtype, capacity_factor):
    jc = CFG_MOE.replace(dtype=dtype, capacity_factor=capacity_factor)
    qp, tp = _moe_trees(dtype)
    jp = jax.tree_util.tree_map(lambda v: v[0], qp["stages"]["s0"]["p1"])
    return jc, jp, tql.tree_index(tp["stages"]["s0"]["p1"], 0)


@pytest.mark.parametrize("tokens", [(3, 5), (8, 1)], ids=["chunk", "decode"])
@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype, capacity_factor, tokens):
    """The model's MoE FFN (norm, routed experts on JAX's quantized
    expert weights, shared experts none here) on (B, S) tokens; at
    capacity factor 0.5 and at the decode shape assignments are dropped,
    as JAX drops them."""
    jc, jp, tp = _moe_layer(dtype, capacity_factor)
    t = tokens[0] * tokens[1]
    assert tmoe.capacity(t, jc.top_k, jc.n_experts, capacity_factor) == \
        max(1, int(t * jc.top_k * capacity_factor) // jc.n_experts)
    rng = np.random.default_rng(2)
    xj = jnp.asarray(rng.standard_normal(tokens + (jc.d_model,)),
                     jnp.float32).astype(jc.cdtype)
    want = np.asarray(JM.moe_ffn(jc, jp, xj)[0].astype(jnp.float32))
    got = TM.moe_ffn(tconfig(jc), tp, to_tensor(xj))[0]
    assert got.dtype == tconfig(jc).cdtype
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_shared_experts_match_jax():
    """deepseek-moe's layout: routed experts plus two shared experts
    folded into one SwiGLU."""
    jc = CFG_MOE.replace(n_shared_experts=2)
    qp, tp = quantized(jc)
    jp = jax.tree_util.tree_map(lambda v: v[0], qp["stages"]["s0"]["p1"])
    tpp = tql.tree_index(tp["stages"]["s0"]["p1"], 0)
    assert jp["moe"]["w_shared_gate"].w.q.ndim == 2
    xj = jnp.asarray(np.random.default_rng(3).standard_normal((2, 4, 32)),
                     jnp.float32)
    np.testing.assert_allclose(
        TM.moe_ffn(tconfig(jc), tpp, to_tensor(xj))[0].numpy(),
        np.asarray(JM.moe_ffn(jc, jp, xj)[0]), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the batched encoder + matmul entries (plain versions) and expert_linear
# ---------------------------------------------------------------------------

ENTRIES = ("dual", "draft", "packed", "packed_draft", "dense")


def _expert_operands(e, c, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, :, ::7] *= 12                        # live MSB tiles
    x[0, 1:] = 0.0                            # an expert with one token
    leaf = jnp.asarray(rng.standard_normal((e, k, n)) / np.sqrt(k),
                       jnp.float32)
    return jnp.asarray(x), jql.quantize_leaf(leaf, tile_k=16)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("shape", [(4, 3, 64, 24), (3, 17, 200, 40)],
                         ids=["c3", "c17-ragged"])
def test_batched_accumulators_match_jax(entry, shape):
    """The port's batched fused encoder and batched matmul entry (their
    plain versions, one expert at a time) give JAX's batched int32
    accumulator bit for bit, per expert clip mask included."""
    e, c, k, n = shape
    xj, sl = _expert_operands(e, c, k, n, seed=k)
    qa = jquantize_act(xj, bits=8, per_token=True)
    q = japply_clipping(qa.q, sl.col_mask[:, None, :], sl.l, sl.h)
    wq = sl.unpacked_q()
    packed = entry.startswith("packed")
    if entry == "dense":
        want = jql._single_pass_matmul(q, wq, True)
    else:
        want = jql._dual_pass_matmul(
            q, wq, True, "packed" if packed else "unpacked",
            msb_skip=entry.endswith("draft"))
    x, mask = to_tensor(xj), to_tensor(sl.col_mask)
    wp = to_tensor(sl.w.q)
    wsc = to_tensor(sl.w.scale).reshape(e, 1, n)
    clip = (mask, int(sl.l), int(sl.h))
    skip = entry.endswith("draft")
    if entry == "dense":
        qt, scale = SE.sparqle_quantize_fused(x, *clip)
        got = QM.quant_matmul(qt, wp, scale, wsc, acc_out=True)
    elif packed:
        lsb, msb, _, pop, scale = SE.sparqle_encode_packed_fused(x, *clip)
        assert pop.shape == (e, -(-c // TILE_M), -(-k // TILE_K))
        got = SM.sparqle_matmul_packed(lsb, msb, pop, wp, scale, wsc,
                                       acc_out=True, msb_skip=skip)
    else:
        lsb, msb, _, pop, scale = SE.sparqle_encode_fused(x, *clip,
                                                          with_pbm=False)
        got = SM.sparqle_matmul(lsb, msb, pop, wp, scale, wsc, acc_out=True,
                                msb_skip=skip)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(qa.scale))
    assert got.dtype == torch.int32 and got.shape == (e, c, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sparqle", "dense"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_expert_linear_matches_jax(mode, dtype):
    xj, sl = _expert_operands(4, 5, 96, 48, seed=1)
    sl = dataclasses.replace(sl, mode=mode)
    xj = xj.astype(dtype)
    want = jql.expert_linear(xj, sl)
    tsl = convert_tree(jax.tree_util.tree_map(np.asarray, {"w": sl}))["w"]
    got = tql.expert_linear(to_tensor(xj), tsl)
    assert got.dtype == to_tensor(xj).dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_quantize_model_params_expert_rule_matches_jax():
    """Routed experts (under ``moe/``, not shared) quantize (E, K, N) a
    layer with a mask an expert, layer-stacked (L, E, K/2, N); shared
    experts and the rest per layer (K, N); the router stays float. The
    port's rule on JAX's float tree gives JAX's quantized tree, and
    ``init_quantized_params`` builds the same structure."""
    from repro.models.schema import init_params as jinit
    from repro.models.schema_builder import build_schema as jschema
    from repro_torch.models.schema import init_quantized_params
    from repro_torch.models.schema_builder import build_schema as tschema
    jc = CFG_MOE.replace(n_shared_experts=1)
    fp = jinit(jschema(jc), jax.random.PRNGKey(0))
    jq = jql.quantize_model_params(fp, w_bits=4, tile_k=16)
    tq = tql.quantize_model_params(
        convert_tree(jax.tree_util.tree_map(np.asarray, fp)), w_bits=4,
        tile_k=16)
    want = convert_tree(jax.tree_util.tree_map(np.asarray, jq))
    built = init_quantized_params(tschema(tconfig(jc)), 0, CPU, tile_k=16)
    moe_j, moe_t = want["stages"]["s0"]["p1"]["moe"], \
        tq["stages"]["s0"]["p1"]["moe"]
    assert moe_t["w_gate"].w.q.shape == (2, 4, 16, 32)
    assert moe_t["w_gate"].col_mask.shape == (2, 4, 32)
    assert moe_t["w_shared_up"].w.q.shape == (2, 16, 32)
    assert isinstance(moe_t["w_router"], torch.Tensor)

    def flat(tree, out, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}"
            if isinstance(v, dict):
                flat(v, out, p)
            elif isinstance(v, tql.SparqleLinear):
                for f in ("q", "scale"):
                    out[f"{p}.{f}"] = getattr(v.w, f)
                out[f"{p}.mask"], out[f"{p}.l"] = v.col_mask, v.l
            else:
                out[p] = v
        return out
    a, b, c = flat(tq, {}), flat(want, {}), flat(built, {})
    assert a.keys() == b.keys() == c.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert a[key].shape == c[key].shape, key


# ---------------------------------------------------------------------------
# one launch a routed projection (the kernel branch, recorded on the CPU)
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper's
    kernel branch runs here and its launch can be recorded."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def record(monkeypatch):
    calls = []
    for k in list(SE.__dict__.values()) + list(SM.__dict__.values()) + \
            [QM.KERNEL, QM.BATCHED_KERNEL]:
        if hasattr(k, "launch") and hasattr(k, "symbol"):
            monkeypatch.setattr(k, "launch", lambda *a, k=k: calls.append(
                (k.name, a)))
    monkeypatch.setitem(SM._COUNTERS, CPU,
                        torch.zeros(SM.TARGET_BLOCKS, dtype=torch.int32))
    return calls


@pytest.mark.parametrize("fn,name", [
    (SE.sparqle_encode_fused, "sparqle_encode_fused_batched"),
    (SE.sparqle_quantize_fused, "sparqle_quantize_fused_batched"),
    (SE.sparqle_encode_packed_fused, "sparqle_encode_packed_fused_batched")])
def test_batched_encoder_is_one_launch(record, fn, name):
    e, c, k = 64, 3, 2048
    fn(_card(torch.zeros((e, c, k), dtype=torch.bfloat16)),
       torch.zeros((e, k), dtype=torch.bool), -8, 23)
    assert [n for n, _ in record] == [name]
    args = record[0][1]
    # E, then the live-rows pointer (null: every row live)
    assert args[-2] == e and args[-1] is None and c in args and k in args


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("e,c,k,n", [(64, 1, 2048, 1408), (64, 3, 1408, 2048),
                                     (8, 17, 2048, 1408)])
def test_batched_matmul_is_one_launch(record, entry, e, c, k, n):
    """One launch of the entry's batched instance with (M, N, K, E) = (C,
    N, K, E); no K split at the serving shapes (>= 264 output tiles), and
    the counters of any split plan fit the device's buffer."""
    plane_k = SM.pad_k(k) // 2 if entry.startswith("packed") else k
    planes = [_card(torch.zeros((e, c, plane_k), dtype=torch.int8))
              for _ in range(2)]
    pop = torch.zeros((e, -(-c // TILE_M), -(-k // TILE_K)),
                      dtype=torch.int32)
    wp = torch.zeros((e, k // 2, n), dtype=torch.int8)
    asc, wsc = torch.ones((e, c, 1)), torch.ones((e, 1, n))
    skip = entry.endswith("draft")
    if entry == "dense":
        res = QM.quant_matmul(planes[0], wp, asc, wsc)
    elif entry.startswith("packed"):
        res = SM.sparqle_matmul_packed(*planes, pop, wp, asc, wsc,
                                       msb_skip=skip)
    else:
        res = SM.sparqle_matmul(*planes, pop, wp, asc, wsc, msb_skip=skip)
    names = {"dual": "sparqle_matmul_batched",
             "draft": "sparqle_matmul_draft_batched",
             "packed": "sparqle_matmul_packed_batched",
             "packed_draft": "sparqle_matmul_packed_draft_batched",
             "dense": "quant_matmul_batched"}
    assert [x for x, _ in record] == [names[entry]]
    args = record[0][1]
    plan = SM.launch_plan(c, n, k, e)
    # the K tiles a split, then the live-rows pointer (null: every row)
    assert args[-2] == plan.per and args[-1] is None
    assert tuple(args[-7 if entry.startswith("packed") else -6:][:4]) == \
        (c, n, k, e)
    assert res.shape == (e, c, n)
    assert (plan.splits == 1) == (plan.tiles >= SM.TARGET_BLOCKS)
    if e == 64:
        assert plan.splits == 1
    assert plan.counters <= SM.TARGET_BLOCKS


def test_batched_plan_counters_fit_everywhere():
    for e in (1, 2, 4, 8, 64):
        for c in (1, 3, 17, 64, 65):
            for n in (8, 64, 256, 1408):
                for k in (128, 1408, 10944):
                    plan = SM.launch_plan(c, n, k, e)
                    assert plan.counters <= SM.TARGET_BLOCKS
                    assert plan.blocks >= min(SM.TARGET_BLOCKS,
                                              plan.tiles * plan.n_kt)


def test_moe_spec_engine_under_capacity_drops_matches_jax():
    """At capacity factor 0.25 experts drop assignments, and which ones
    depends on the tokens a step routes together; the speculative engine
    batches other tokens than the base engine, so JAX's speculative
    streams part from JAX's base streams. The port's engines give JAX's
    streams, each its own: the speculative identity with the base engine
    holds where no assignment is dropped, not here."""
    jc = CFG_MOE.replace(capacity_factor=0.25, vocab=512)
    qp, tp = quantized(jc, seed=3)
    reqs = prompts(jc.vocab, lens=((1, 11), (2, 5), (3, 18), (4, 9),
                                   (5, 14), (6, 7)))
    jb = drive(jax_engine(jc, qp), JSampling, reqs, gen=8)
    js = drive(jax_engine(jc, qp, gamma=GAMMA), JSampling, reqs, gen=8)
    tc = tconfig(jc)
    assert drive(port_engine(tc, tp), SamplingParams, reqs, gen=8) == jb
    assert drive(port_engine(tc, tp, gamma=GAMMA), SamplingParams, reqs,
                 gen=8) == js
    assert js != jb

"""The compiled-step layer (``repro_torch.launch.graphs``) on the CPU.

A CUDA graph cannot be captured here, so the capture has a stand-in,
:class:`FxGraph`: ``make_fx`` traces the step once and the traced module
replays it. The trace has a capture's constraints — it bakes every Python
value into the graph and refuses to read a traced tensor on the host
(``.item()``) — and it replays in-place writes to the pool. So each
step of the engines, of the fixed-batch path (prefill into used caches,
decode) and of the KV2 ladder (the page re-codecs), traced at one input
and run at two later ones (``chip_smoke.graph_cases``: moved positions
and block tables, an inactive slot, prefill chunks with valid = C and
valid < C at other starts, new prompts, other page ids), must give the
eager step's bits: logits, telemetry and every pool or cache byte.
Also here: the tensor-start/valid prefill chunk against JAX's
``prefill_chunk_paged`` (logits within 1e-4, telemetry and pool nibbles
exact, pool scales within 1e-6 relative, as ``test_torch_model.py``
holds the steps); the launch counters under capture and replay (a stub
kernel); the runner's cache key, its raise when persistent state
moves, its clones; the engines and the fixed-batch loop through the
traced runner give the eager streams,
and three serves through one ``LegacySteps`` warm the prefill up,
capture it and replay it; a capture that fails raises.

The ``cuda`` cases run the real capture on the card (replay = eager bits
for each step kind; a graph serve = an eager serve, streams and launch
counts) and skip here. This file imports JAX only inside the one test
that compares with it, so the card's machine, which has no JAX, runs:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_graphs.py
"""
import dataclasses
import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.launch import graphs as G
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.graphs import CompiledStep, disable_graphs
from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                      make_engine, make_prompts, run_requests)
from repro_torch.serving import engine as engine_mod

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import graph_cases, replay_vs_eager  # noqa: E402

TCFG = ModelConfig(name="tiny-serve", family="transformer", n_layers=2,
                   d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                   vocab=128, dtype="float32")
# graph_cases at this size: 3 slots x 6 pages of 4 tokens, chunks of 8
SIZES = dict(b=3, ps=4, n_s=6, chunk=8, gamma=2)
KINDS = ("prefill_chunk", "decode", "draft", "verify", "kv2_decode",
         "legacy_decode", "legacy_prefill", "kv2_demote", "kv2_promote")
CPU = torch.device("cpu")


class FxGraph:
    """The CPU stand-in for ``graphs.CudaGraph``. :meth:`capture` traces
    the step with ``make_fx`` on the captured arguments, then restores
    every persistent tensor the trace wrote (a capture executes nothing)
    and returns outputs of the traced module's layout, persistent state
    as the argument it came in (as a capture returns it); :meth:`replay`
    runs the traced module on the captured arguments and writes its
    results into those outputs, where a graph replay leaves them."""

    def __init__(self, mempool=None):
        self.gm = self.args = self.out = None

    def capture(self, fn, args):
        state = [t for a in args if isinstance(a, dict)
                 for t in G._state_leaves(a) if isinstance(t, torch.Tensor)]
        saved = [t.clone() for t in state]
        self.gm, self.args = make_fx(fn)(*args), args
        self.out = _as_args(self.gm(*args), args)
        for t, v in zip(state, saved):
            t.copy_(v)
        return self.out

    def replay(self):
        for mine, new in zip(pytree.tree_leaves(self.out),
                             pytree.tree_leaves(self.gm(*self.args))):
            if isinstance(mine, torch.Tensor) and mine is not new:
                mine.copy_(new)


def _as_args(out, args):
    """``out`` with each dict that holds the tensors of a dict argument
    replaced by that argument (the traced module rebuilds its dicts)."""
    def tensors(tree):
        return [id(t) for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    if isinstance(out, dict):
        for a in args:
            if isinstance(a, dict) and tensors(out) == tensors(a):
                return a
        return {k: _as_args(v, args) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_as_args(v, args) for v in out)
    return out


traced = functools.partial(CompiledStep, graph_type=FxGraph)


@pytest.fixture(scope="module")
def params():
    return build_served_params(TCFG, 0, CPU, tile_k=16)


@pytest.mark.parametrize("kind", KINDS)
def test_traced_step_replays_eager_bits(params, kind):
    """Traced at the second call's input, run at the second, third and
    fourth: outputs and the state after each call bit-equal to the eager
    step's, one graph for the four calls."""
    case = next(c for c in graph_cases(TCFG, params, CPU, 0, **SIZES)
                if c[0] == kind)
    assert replay_vs_eager(CPU, case, graph_type=FxGraph)


def test_traced_prefill_chunk_matches_jax():
    """Three chunks (valid = C, then a short one, then another sequence)
    through one traced prefill graph, start and valid as (1,) int32
    tensors, against JAX's jitted prefill step with traced scalars."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JConfig
    from repro.core.qlinear import quantize_model_params as jquantize
    from repro.launch import steps as JS
    from repro.models.schema import init_params as jinit
    from repro.models.schema_builder import build_schema as jschema
    from repro.serving.kv_pool import PoolConfig as JPoolConfig
    from repro.serving.kv_pool import init_pool_state as jinit_pool
    from repro_torch.convert import convert_tree, to_numpy_tree
    from repro_torch.launch import steps as TS

    cfg = JConfig(**dataclasses.asdict(TCFG))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    qparams = jquantize(jinit(jschema(cfg), jax.random.PRNGKey(0)), w_bits=4,
                        k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                        enable_clipping=True, tile_k=16)
    tparams = convert_tree(np_tree(qparams))
    ps, n_pages, pmax, chunk = 4, 12, 4, 8
    jpool = jinit_pool(cfg, JPoolConfig(n_pages=n_pages, page_size=ps))
    tpool = convert_tree(np_tree(jpool))
    jprefill = jax.jit(JS.make_engine_prefill_chunk(cfg))
    tprefill = traced(TS.make_engine_prefill_chunk(TCFG), CPU)
    rng = np.random.default_rng(0)
    seq_a, seq_b = rng.integers(0, cfg.vocab, 10), rng.integers(0, cfg.vocab, 5)
    for seq, pages, start, n in ((seq_a, [3, 7, 1], 0, chunk),
                                 (seq_a, [3, 7, 1], chunk, 2),
                                 (seq_b, [5, 2], 0, 5)):
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = seq[start:start + n]
        tbl = np.zeros((1, pmax), np.int32)
        tbl[0, :len(pages)] = pages
        jl, jpool, jt = jprefill(qparams, jpool, jnp.asarray(toks),
                                 jnp.int32(start), jnp.int32(n),
                                 jnp.asarray(tbl))
        i32 = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
        tl, tpool, tt = tprefill(tparams, tpool, torch.from_numpy(toks),
                                 i32(start), i32(n), torch.from_numpy(tbl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        jt, tt = np_tree(jt), to_numpy_tree(tt)
        for key in ("sparsity", "layer_sparsity", "layer_wire_bytes",
                    "layer_dense_bytes"):
            np.testing.assert_array_equal(tt[key], jt[key])
    assert tprefill.graphs == 1
    jp = np_tree(jpool)["stages"]["s0"]["p0"]
    tp = to_numpy_tree(tpool)["stages"]["s0"]["p0"]
    for key in ("k_q", "v_q"):                # page 0 (null) excluded
        np.testing.assert_array_equal(tp[key][:, 1:], jp[key][:, 1:])
    for key in ("k_s", "v_s"):
        np.testing.assert_allclose(tp[key][:, 1:], jp[key][:, 1:], rtol=1e-6)
    assert (tp["k_q"][:, [1, 2, 3, 5, 7]] != 0).any()


@pytest.fixture
def stub_kernel(monkeypatch):
    """A registered kernel whose C entry is a Python stub, launched on a
    stand-in stream."""
    k = _build.Kernel("sparqle_matmul.cu", "stub_launch", [], name="stub")
    k._fn = lambda stream: 0
    monkeypatch.setitem(_build.KERNELS, k.name, k)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    return k


def test_launch_counts_under_capture_and_replay(stub_kernel):
    """Eager launches count; launches inside a recording (the runner's
    capture) count nowhere but the recording; each replay adds the
    recording once; ``reset_launch_counts`` zeroes what both added."""
    _build.reset_launch_counts()
    stub_kernel.launch()
    with _build.recording_launches() as rec:
        stub_kernel.launch()
        stub_kernel.launch()
    assert stub_kernel.launches == 1 and rec == {stub_kernel: 2}
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert _build.launch_counts()["stub"] == 5
    stub_kernel.launch()
    assert stub_kernel.launches == 6
    _build.reset_launch_counts()
    assert stub_kernel.launches == 0 and rec == {stub_kernel: 2}


def test_runner_counts_what_eager_counts(stub_kernel):
    """A step that launches the kernel twice a call: four calls through
    the runner (warm-up, capture, two replays) count what four eager
    calls count."""
    def fn(state, x):
        stub_kernel.launch()
        stub_kernel.launch()
        state["acc"].add_(x)
        return x * 2, state

    counts = []
    for step in (fn, traced(fn, CPU)):
        _build.reset_launch_counts()
        state = {"acc": torch.zeros(3)}
        for i in range(4):
            step(state, torch.full((3,), float(i)))
        counts.append(stub_kernel.launches)
        assert torch.equal(state["acc"], torch.full((3,), 6.0))
    assert counts == [8, 8]


@dataclasses.dataclass
class Proj:
    w: torch.Tensor
    mode: str = "sparqle"


def test_runner_cache_key_and_state_binding():
    """One graph per input shape and dtype, captured at a shape's second
    call; a persistent dataclass field (a projection's mode) is part of
    the key; a call whose persistent tensors moved raises, and so does a
    Python value among the arguments."""
    def fn(state, x):
        y = x * state["p"].w if state["p"].mode == "sparqle" else x - 1
        state["acc"].add_(y.sum().to(state["acc"].dtype))
        return y, state

    state = {"p": Proj(torch.full((1,), 3.0)), "acc": torch.zeros(())}
    twin = {"p": Proj(state["p"].w.clone()), "acc": torch.zeros(())}
    step = traced(fn, CPU)
    seq = [torch.ones(2), torch.arange(2.0), torch.ones(5), torch.ones(2) * 4,
           torch.ones(5) * 2, torch.ones(2, dtype=torch.float64),
           torch.ones(5), torch.ones(2, dtype=torch.float64)]
    graphs = []
    for x in seq:
        y, out = step(state, x)
        want, _ = fn(twin, x)
        assert out is state and torch.equal(y, want)
        graphs.append(step.graphs)
    assert graphs == [0, 1, 1, 1, 2, 2, 2, 3]
    assert torch.equal(state["acc"], twin["acc"])
    dense = {"p": Proj(state["p"].w, mode="dense"), "acc": state["acc"]}
    step(dense, torch.ones(2))
    y, _ = step(dense, torch.ones(2))
    assert step.graphs == 4 and torch.equal(y, torch.zeros(2))
    with pytest.raises(RuntimeError, match="moved"):
        step({"p": Proj(torch.full((1,), 3.0)), "acc": state["acc"]},
             torch.ones(2))
    with pytest.raises(TypeError, match="Python value"):
        step(state, 3)


def test_runner_eager_on_cpu_and_under_disable_graphs():
    """On the CPU (no graph type) and inside ``disable_graphs`` every call
    runs the closure itself: nothing is keyed or captured."""
    calls = []

    def fn(state, x):
        calls.append(x)
        return x, state

    plain = CompiledStep(fn, CPU)
    assert plain(None, 3) == (3, None)
    step = traced(fn, CPU)
    with disable_graphs():
        for i in range(3):
            assert step({}, torch.ones(i + 1))[0] is calls[-1]
    assert step.graphs == 0 and len(calls) == 4
    step({}, torch.ones(1))
    step({}, torch.ones(1))
    assert step.graphs == 1


def test_runner_returns_clones(params, monkeypatch):
    """The fixed-batch loop keeps every decode step's token: through the
    traced runner its streams equal the eager loop's (an output that
    aliased the graph's own would repeat the last token), and two calls'
    outputs are distinct tensors that keep their values."""
    prompts = make_prompts(TCFG, 0, 3, 10)
    with disable_graphs():
        want = legacy_serve(TCFG, params, prompts, 6, CPU)["streams"]
    assert any(len(set(s)) > 1 for s in want)
    monkeypatch.setattr(serve_mod, "CompiledStep", traced)
    assert legacy_serve(TCFG, params, prompts, 6, CPU)["streams"] == want

    case = next(c for c in graph_cases(TCFG, params, CPU, 1, **SIZES)
                if c[0] == "legacy_decode")
    _, fn, (p, cache), calls = case
    step = traced(fn, CPU)
    outs = [step(p, cache, *args)[0] for args in calls]
    kept = [o.clone() for o in outs]
    step(p, cache, *calls[0])
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))


def test_legacy_serves_replay_one_prefill_graph(params, monkeypatch):
    """Three serves of one shape through one ``LegacySteps`` and the
    traced runner: the prefill warms up, is captured, then replays (its
    replayed time reported), one graph each for the prefill and the
    decode, every serve's streams the eager serve's of its prompts."""
    prompts = [make_prompts(TCFG, seed, 3, 10) for seed in (0, 1, 0)]
    with disable_graphs():
        want = [legacy_serve(TCFG, params, p, 6, CPU)["streams"]
                for p in prompts]
    monkeypatch.setattr(serve_mod, "CompiledStep", traced)
    steps = serve_mod.LegacySteps(TCFG, 3, 16, CPU)
    runs = [legacy_serve(TCFG, params, p, 6, CPU, steps=steps)
            for p in prompts]
    assert [r["streams"] for r in runs] == want
    assert [r["prefill_call"] for r in runs] == ["warm-up", "capture",
                                                 "replay"]
    assert [r["prefill_replay_s"] is None for r in runs] == [True, True,
                                                             False]
    assert steps.prefill.graphs == steps.decode.graphs == 1
    assert [r["decode_timed_steps"] for r in runs] == [3, 5, 5]


def test_capture_failure_raises(params):
    """A step that reads a device value on the host runs its eager
    warm-up, then its capture raises: no call falls back to eager."""
    def host_read(state, x):
        return x * float(x.sum())

    step = traced(host_read, CPU)
    step({}, torch.ones(3))
    with pytest.raises(RuntimeError):
        step({}, torch.ones(3))
    assert step.graphs == 0
    with pytest.raises(RuntimeError):
        step({}, torch.ones(3))


@pytest.mark.parametrize("graphs,gen,warm", [(True, 6, 2), (False, 6, 1),
                                             (True, 3, 0)])
def test_legacy_decode_time_is_the_steps_after_warmup(params, monkeypatch,
                                                      graphs, gen, warm):
    """``legacy_serve`` times the decode's warm-up apart: its eager call
    and its capture under graphs, its first step without, none when no
    step would be left. On a clock that such a step moves by 100 and a
    replay (or a later eager step) by 1, ``decode_step_s`` is 1 and
    ``decode_warmup_s`` 100 a warm-up step."""
    clock = [0.0]

    class Clocked(CompiledStep):
        def __init__(self, fn, device):
            super().__init__(fn, device,
                             graph_type=FxGraph if graphs else None)
            self.calls = 0

        def __call__(self, *args):
            later = self.graphs > 0 if self.captures else self.calls > 0
            self.calls += 1
            out = super().__call__(*args)
            clock[0] += 1.0 if later else 100.0
            return out

    monkeypatch.setattr(serve_mod, "CompiledStep", Clocked)
    monkeypatch.setattr(serve_mod, "time",
                        SimpleNamespace(perf_counter=lambda: clock[0]))
    r = legacy_serve(TCFG, params, make_prompts(TCFG, 0, 2, 8), gen, CPU)
    assert r["decode_steps"] == gen - 1
    assert r["decode_timed_steps"] == gen - 1 - warm
    assert r["decode_warmup_s"] == 100.0 * warm
    assert r["decode_step_s"] == (1.0 if warm else 100.0)


@pytest.mark.parametrize("kind", ["base", "spec", "kv2"])
def test_engines_through_traced_runner(params, monkeypatch, kind):
    """The engine (base, γ = 2, the KV2 ladder's aggressive sweep) with
    its steps through the traced runner: the eager engine's streams, one
    graph per step (every prefill chunk shares one, start and valid
    being inputs)."""
    prompts = make_prompts(TCFG, 2, 3, 13)
    kw = dict(batch=3, prompt_len=13, gen=6, page_size=4, prefill_chunk=8,
              token_budget=16, spec_gamma=2 if kind == "spec" else 0,
              device=CPU)
    if kind == "kv2":
        kw.update(kv2_pages=20, demote_after_steps=1, demote_min_sparsity=0.0)
    with disable_graphs():
        want = run_requests(make_engine(TCFG, params, **kw), prompts, 6)
    monkeypatch.setattr(engine_mod, "CompiledStep", traced)
    eng = make_engine(TCFG, params, **kw)
    got = run_requests(eng, prompts, 6)
    assert got["streams"] == want["streams"]
    assert got["steps"] == want["steps"]
    steps = [eng._prefill_fn] + ([eng._draft_fn, eng._verify_fn]
                                 if kind == "spec" else [eng._decode_fn])
    assert [s.graphs for s in steps] == [1] * len(steps)
    if kind == "kv2":
        assert got["aggregate"]["pool_demotions"] > 0
        assert got["aggregate"] == want["aggregate"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode; the "
                    "traced stand-in above runs here)")
    return torch.device("cuda", 0)


@pytest.fixture
def smoke(cuda):
    from repro_torch.configs import get_config
    cfg = get_config("granite-8b", smoke=True)
    return cfg, build_served_params(cfg, 0, cuda, tile_k=16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_graph_replays_eager_bits(cuda, smoke, kind):
    """The granite-8b smoke config (hd 16, G 2), pages of 8: each step
    kind captured into a CUDA graph and replayed gives the eager call's
    bits."""
    cfg, p = smoke
    case = next(c for c in graph_cases(cfg, p, cuda, 0, ps=8, n_s=6,
                                       chunk=16) if c[0] == kind)
    assert replay_vs_eager(cuda, case)


@pytest.mark.cuda
def test_cuda_legacy_serves_replay_the_prefill(cuda, smoke):
    """Three ``--legacy`` serves through one ``LegacySteps`` on the card:
    the prefill warms up, is captured, then replays; every serve's
    streams and launch counts are an eager serve's."""
    from repro_torch import kernels
    cfg, p = smoke
    prompts = make_prompts(cfg, 5, 4, 21)
    kernels.reset_launch_counts()
    with disable_graphs():
        want = legacy_serve(cfg, p, prompts, 7, cuda)["streams"]
    counts = kernels.launch_counts()
    steps = serve_mod.LegacySteps(cfg, 4, 28, cuda)
    for call in ("warm-up", "capture", "replay"):
        kernels.reset_launch_counts()
        r = legacy_serve(cfg, p, prompts, 7, cuda, steps=steps)
        assert (r["prefill_call"], r["streams"]) == (call, want)
        assert kernels.launch_counts() == counts
    assert steps.prefill.graphs == steps.decode.graphs == 1


@pytest.mark.cuda
def test_cuda_graph_serve_equals_eager_serve(cuda, smoke):
    """The engine and the speculative engine on the card: graph serves
    give the eager serves' streams and per-kernel launch counts."""
    from repro_torch import kernels
    cfg, p = smoke
    prompts = make_prompts(cfg, 5, 4, 21)
    for gamma in (0, 2):
        runs = []
        for eager in (True, False):
            kernels.reset_launch_counts()
            eng = make_engine(cfg, p, batch=4, prompt_len=21, gen=9,
                              page_size=8, spec_gamma=gamma, device=cuda)
            if eager:
                with disable_graphs():
                    r = run_requests(eng, prompts, 9)
            else:
                r = run_requests(eng, prompts, 9)
                steps = [eng._prefill_fn] + (
                    [eng._draft_fn, eng._verify_fn] if gamma
                    else [eng._decode_fn])
                assert [s.graphs for s in steps] == [1] * len(steps)
            runs.append((r["streams"], kernels.launch_counts()))
        assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda):
    """A host read inside a step: the capture raises on the card, no
    fallback to eager (last in the file: a failed capture is the one
    card case that could leave the context unusable)."""
    def host_read(state, x):
        return x * float(x.sum())

    step = CompiledStep(host_read, cuda)
    step({}, torch.ones(3, device=cuda))
    with pytest.raises(RuntimeError):
        step({}, torch.ones(3, device=cuda))

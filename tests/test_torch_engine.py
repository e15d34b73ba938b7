"""Port parity, serving: the same staggered requests through the JAX
``Engine`` and the port's ``Engine`` (on the CPU, plain versions) give
identical greedy token streams, the same number of engine steps and the
same integer ``aggregate_stats()`` counters — including a run with
chunked prefill and a run that preempts. Also: the port's entry points
default to CUDA and raise without a card."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PoolConfig as JPool
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig)

CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              vocab=128, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
INT_KEYS = ("steps", "pool_pages_free", "pool_evictions")


@pytest.fixture(scope="module")
def qparams():
    fp = jinit(jschema(CFG), jax.random.PRNGKey(0))
    return jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     enable_clipping=True, tile_k=16)


def _drive(eng, sampling_cls, script):
    """``script``: list of (steps_before, prompt, max_new) submissions."""
    handles = []
    for steps_before, prompt, gen in script:
        for _ in range(steps_before):
            eng.step()
        handles.append(eng.submit(prompt, sampling_cls(max_new_tokens=gen)))
    eng.run()
    return [list(h.out_tokens) for h in handles]


def _both(qparams, script, n_pages, slots, budget, chunk, ps=4):
    kw = dict(max_decode_batch=slots, token_budget=budget,
              prefill_chunk=chunk, max_pages_per_seq=8)
    j = JEngine(CFG, qparams, pool_config=JPool(n_pages=n_pages,
                                                page_size=ps),
                sched_config=JSched(**kw))
    t = Engine(TCFG, convert_tree(jax.tree_util.tree_map(np.asarray,
                                                         qparams)),
               pool_config=PoolConfig(n_pages=n_pages, page_size=ps),
               sched_config=SchedulerConfig(**kw), device="cpu")
    return ((_drive(j, JSampling, script), j),
            (_drive(t, SamplingParams, script), t))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).tolist()


def _assert_same(j, t):
    (js, je), (ts, te) = j, t
    assert ts == js
    ja, ta = je.aggregate_stats(), te.aggregate_stats()
    for k in INT_KEYS:
        assert ta[k] == ja[k], k
    assert ta["wire_bytes_total"] == ja["wire_bytes_total"]
    assert te.wire_tokens == je.wire_tokens
    return ja


def test_engine_streams_match_jax_chunked_prefill(qparams):
    script = [(0, _prompt(1, 11), 6), (0, _prompt(2, 5), 5),
              (2, _prompt(3, 20), 4)]        # 20 > chunk 8: chunked
    j, t = _both(qparams, script, n_pages=24, slots=3, budget=12, chunk=8)
    agg = _assert_same(j, t)
    assert agg["pool_evictions"] == 0
    assert [len(s) for s in t[0]] == [6, 5, 4]


def test_engine_streams_match_jax_with_preemption(qparams):
    script = [(0, _prompt(4, 6), 9), (0, _prompt(5, 7), 9)]
    j, t = _both(qparams, script, n_pages=7, slots=2, budget=16, chunk=8)
    agg = _assert_same(j, t)
    assert agg["pool_evictions"] > 0
    name = "serving_preemptions_total"
    assert t[1].obs.registry.value(name) == j[1].obs.registry.value(name) > 0


def test_engine_default_device_raises_without_cuda(qparams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    params = convert_tree(jax.tree_util.tree_map(np.asarray, qparams))
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(TCFG, params)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "granite-8b", "--smoke"])

"""Serving driver on the SPARQLe quantized path (the paged engine).

Serves every architecture the JAX engine serves: granite-8b, yi-6b,
starcoder2-3b (LayerNorm, biases, GELU MLP) and deepseek-moe-16b (routed
+ shared MoE FFNs). Requests are admitted FCFS under a token budget into
a paged packed-KV4 pool, prefill is chunked, decode slots are backfilled
every step, and every projection runs the fused encoder + dual-pass W4A8
matmul kernels (a routed MoE projection their expert-batched instances,
one launch each for all experts) while decode attention runs the paged
KV4 kernel. Weights are drawn from ``--seed`` on the device and
quantized one layer at a time, or with ``--ckpt DIR`` restored as the
float tree of the newest complete checkpoint under DIR
(``checkpoint/store.py``, the JAX package's format) and quantized one
layer at a time on the device; prompts are the synthetic stream's first
batch (``data/pipeline.py`` ``SyntheticLM``), as the JAX serve's.
Prints per-request TTFT/TPOT, tokens/s, the achieved MSB4 sparsity and
the measured wire compression, then the closing report of both paths:
the MSB4 sparsity of the prompts' hidden stream (``forward_hidden``)
and the paper accelerator's cost-model prediction at that sparsity
(``core/costmodel.py`` ``evaluate_model``: the §4 model, not a
measurement of the card).
``--spec-gamma N`` serves through the self-speculative engine (N
LSB4-only draft steps and one batched verify per cycle) and also prints
the draft acceptance rate and the tokens emitted per cycle. ``--mode
dense`` serves the paper's W4A8 baseline instead: the same int4 weights,
each projection one int8 x int4 pass (quantize-only encoder + dense
matmul kernels), no sub-precision split.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --spec-gamma 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --mode dense
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --smoke --device cpu [--spec-gamma 2] [--mode dense]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b [--ckpt DIR]

``--legacy`` serves the fixed-batch path instead: one whole-prompt
prefill into a contiguous packed-KV4 cache a layer, then lockstep greedy
decode steps through the contiguous KV4 decode kernel. On a CUDA device
the prefill (over caches allocated outside it) and the decode step run
as CUDA graphs (``launch/graphs.py``), as do the engine's steps: a
single serve warms the prefill up eagerly, and a process that serves one
shape again with the same ``LegacySteps`` replays it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --legacy

The gemma family serves through ``--legacy`` only, as in the JAX
package, whose paged check refuses sliding windows and VLMs (without
``--legacy`` the serve exits naming the window or the VLM):
gemma3-27b (5 sliding-window layers of 1,024 keys to 1 global, qk-norm,
GeGLU) and paligemma-3b (a bidirectional prefix of 256 stub image
patches, drawn from ``--seed``, in front of ``--prompt-len`` minus 256
prompt tokens; hd 256).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --legacy --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --legacy --prompt-len 512

deepseek-v3-671b serves through ``--legacy`` only too (the paged check
refuses its MLA layers, naming the ``mla`` mixer): absorbed MLA on a
packed-int4 compressed KV cache, 256 routed experts with top-8 sigmoid
routing after 3 dense layers, an untied head. Its 671 B parameters do
not fit one card; ``chip_smoke.py`` serves it at full width and cut
depth (``cfg.replace(n_layers=7)``: the 3 dense and 4 MoE layers).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --legacy

The SSD family serves through ``--legacy`` only too (the paged check
refuses its SSD layers, naming the ``ssd`` mixer): mamba2-2.7b (64
Mamba-2 SSD layers, no FFN, tied head) and jamba-v0.1-52b (4 periods of
7 SSD layers and 1 attention layer, a 16-expert top-2 MoE on every second
layer); an SSD layer's cache holds its recurrent state and conv tail
in place of K/V.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --legacy --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --legacy --prompt-len 128

``--mesh D,M`` serves on a ("data", "model") mesh of D x M ranks
(tensor-parallel serving, ``distributed/tp.py``): the weights are built
once in this process and reach each rank's process (spawned with
``torch.multiprocessing``, joined through a ``FileStore`` under a
temporary directory) through shared memory, or CUDA IPC on a card; each
rank cuts its shard, builds the same prompts and runs the same host
loop; rank 0's run is printed. Weights shard Megatron-style over model,
the pool on KV heads over model and on pages over data, decode slots
over data; the greedy streams are the single-device serve's. NCCL takes
one card a rank; with fewer cards than ranks pass ``--dist-backend
gloo``, which shares the cards and runs the steps eagerly (gloo's
collectives cannot be captured in a CUDA graph); the run says which.
``--mesh`` drives the paged engine, not ``--legacy``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --mesh 1,2 --dist-backend gloo

``--slo SPEC`` (repeatable, comma lists: ``ttft:p95<0.5``,
``tpot:p50<0.05``, ``queue_depth:p50<4``) arms the engine's SLO watchdog
and prints each SLO's windowed percentile, violations and burn rate;
``--attribute`` counts each serving step's work from its shapes
(``launch/step_cost.py``) and prints per phase the attributed FLOPs and
HBM bytes a step, then the achieved bytes/s and the memory and compute
utilisation against the card's peaks (``obs/attribution.py``). Both
drive the paged engine's observability and are refused with
``--legacy``. Under ``--mesh`` every rank attributes its own shard and
rank 0's report is printed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --slo ttft:p95<60,tpot:p50<0.05 --attribute --metrics-out m.json

The KV2 precision ladder has no flag here, as in the JAX package's
serve: arm it through ``make_engine(..., kv2_pages=N)`` or
``PoolConfig(kv2_pages=N)``; nor has the packed wire format: serve a
``quantize_model_params(..., wire_format="packed")`` tree.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import (HardwareConfig, evaluate_model,
                                        lm_shape_of)
from repro_torch.core.qlinear import quantize_model_params
from repro_torch.core.quantize import quantize_activations
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.launch.graphs import CompiledStep
from repro_torch.launch.mesh import (make_mesh, mesh_layout, pick_backend,
                                     spawn_world)
from repro_torch.models.model import (check_contiguous_support,
                                      check_paged_support, forward_hidden,
                                      init_cache)
from repro_torch.models.schema import abstract_params, init_quantized_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.obs.slo import parse_slo_list
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig, SpecConfig,
                                 SpeculativeEngine)
from repro_torch.serving.engine import resolve_device


def build_served_params(cfg: ModelConfig, seed: int, device, *,
                        k_percent: float = 50.0, clip_l: float = -8.0,
                        clip_h: float = 23.0, enable_clipping: bool = True,
                        tile_k: int = 128, mode: str = "sparqle"):
    """The served tree (``mode`` 'sparqle' or the 'dense' baseline) drawn
    from ``seed`` directly on ``device``."""
    return init_quantized_params(
        build_schema(cfg), seed, device, float_dtype=cfg.cdtype,
        w_bits=cfg.w_bits, k_percent=k_percent, clip_l=clip_l,
        clip_h=clip_h, enable_clipping=enable_clipping, tile_k=tile_k,
        mode=mode)


def restore_served_params(cfg: ModelConfig, path: str, device, *,
                          mode: str = "sparqle", **quant_kw):
    """The served tree of the float params in the newest complete
    checkpoint under ``path`` (JAX's ``store.save`` of ``{"params":
    tree}``, or the port's): restored on the host, then each projection
    quantized one layer at a time on ``device``."""
    step = store.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {path!r}")
    like = {"params": abstract_params(build_schema(cfg))}
    params = store.restore(path, step, like)["params"]
    return quantize_model_params(params, w_bits=cfg.w_bits, mode=mode,
                                 device=device, **quant_kw)


def make_prompts(cfg: ModelConfig, seed: int, batch: int,
                 prompt_len: int) -> List[List[int]]:
    """Uniform random prompts (the card smoke's serves)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, prompt_len)).tolist()


def synthetic_prompts(cfg: ModelConfig, seed: int, batch: int,
                      prompt_len: int) -> List[List[int]]:
    """The JAX serve's prompts: ``SyntheticLM``'s first batch."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=prompt_len,
                                  global_batch=batch, seed=seed))
    return data.batch_at(0)["tokens"].tolist()


def make_engine(cfg: ModelConfig, params, *, batch: int, prompt_len: int,
                gen: int, page_size: int = 16, n_pages: int = 0,
                token_budget: int = 128, prefill_chunk: int = 32,
                decode_slots: int = 8, spec_gamma: int = 0,
                device="cuda", mesh=None, slos=None, attribute: bool = False,
                **pool_kw) -> Engine:
    """Engine sized like ``repro.launch.serve``: a block table that fits
    prompt + generation (+ the γ-token draft lookahead), and by default a
    pool that fits the batch. ``spec_gamma > 0`` gives the speculative
    engine; ``pool_kw`` are further :class:`PoolConfig` fields (the KV2
    ladder's ``kv2_pages``, ``demote_min_sparsity``,
    ``demote_after_steps``). With a ``mesh`` the decode slots round up to
    a multiple of the data ways, and the default pool gives every data
    shard room for its share of the batch (a request's pages live in
    one shard). ``slos`` arm the SLO watchdog; ``attribute`` attributes
    the engine's steps (``Engine.attribute_steps``)."""
    data = 1 if mesh is None else mesh_layout(mesh).data_ways
    pages_per_seq = -(-(prompt_len + gen + spec_gamma) // page_size)
    n_slots = min(batch, decode_slots)
    n_slots += (-n_slots) % data
    n_pages = n_pages or data * (1 + pages_per_seq * -(-batch // data))
    n_pages += (-n_pages) % data
    kw = dict(
        pool_config=PoolConfig(n_pages=n_pages, page_size=page_size,
                               **pool_kw),
        sched_config=SchedulerConfig(
            max_decode_batch=n_slots,
            token_budget=token_budget, prefill_chunk=prefill_chunk,
            max_pages_per_seq=pages_per_seq),
        device=device, mesh=mesh, slos=slos)
    if spec_gamma > 0:
        eng = SpeculativeEngine(cfg, params,
                                spec=SpecConfig(gamma=spec_gamma), **kw)
    else:
        eng = Engine(cfg, params, **kw)
    if attribute:
        eng.attribute_steps()
    return eng


def run_requests(eng: Engine, prompts: List[List[int]],
                 gen: int) -> Dict[str, object]:
    """Submit every prompt, drain the engine, and summarise the run (with
    the SLO report and the attribution report when the engine has
    them)."""
    t0 = time.perf_counter()
    handles = [eng.submit(p, SamplingParams(max_new_tokens=gen))
               for p in prompts]
    eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    stats = [h.stats() for h in handles]
    n_tok = sum(s["n_generated"] for s in stats)
    tpot = [s["tpot_s"] for s in stats if np.isfinite(s["tpot_s"])]
    return {
        "requests": len(handles),
        "finished": sum(h.done for h in handles),
        "tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_mean_s": float(np.mean([s["ttft_s"] for s in stats])),
        "ttft_p95_s": float(np.percentile([s["ttft_s"] for s in stats], 95)),
        "tpot_mean_s": float(np.mean(tpot)) if tpot else float("nan"),
        "act_sparsity": float(np.mean([s["act_sparsity"] for s in stats])),
        "steps": eng.steps,
        "streams": [list(h.out_tokens) for h in handles],
        "aggregate": eng.aggregate_stats(),
        "slo": eng.slo.report() if eng.slo is not None else None,
        "attribution": attribution_report(eng),
    }


def attribution_report(eng: Engine) -> Optional[Dict[str, Dict]]:
    """Per attributed phase: its static cost (``StepAttribution.summary``)
    joined with the measured step times as the gauges hold them after
    the last refresh: ``steps``, ``mean_step_s``, achieved
    ``flops_per_s``/``bytes_per_s`` and ``compute_util``/``memory_util``
    against the engine's peaks, ``floor_s`` (bytes over the peak HBM
    rate). The speculative engine's ``decode`` row is marked ``cycle``:
    its timed phase is the whole draft + verify cycle, joined with one
    decode step's cost as the JAX package joins it. None for an engine
    never attributed."""
    attr = eng._attr
    if attr is None:
        return None
    reg, lat = eng.obs.registry, eng._m_step_lat
    spec = isinstance(eng, SpeculativeEngine)
    out = {}
    for phase, row in attr.summary().items():
        row = dict(row, steps=lat.count(phase=phase),
                   floor_s=row["hbm_bytes"] / attr.hw.hbm_bw,
                   cycle=spec and phase == "decode")
        if row["steps"]:
            row.update(
                mean_step_s=lat.mean(phase=phase),
                flops_per_s=reg.value("serving_roofline_achieved_flops_per_s",
                                      phase=phase),
                bytes_per_s=reg.value("serving_roofline_achieved_bytes_per_s",
                                      phase=phase),
                compute_util=reg.value("serving_roofline_compute_util_ratio",
                                       phase=phase),
                memory_util=reg.value("serving_roofline_memory_util_ratio",
                                      phase=phase))
        out[phase] = row
    return out


def closing_report(cfg: ModelConfig, params, prompts: List[List[int]],
                   device, patches: Optional[torch.Tensor] = None
                   ) -> Dict[str, object]:
    """The MSB4 sparsity of the prompts' hidden stream (``forward_hidden``,
    per-token int8; a VLM's ``patches`` in front) and the paper
    accelerator's cost-model prediction at that sparsity
    (``evaluate_model`` with the §4 knobs: a model of the paper's
    accelerator, not of the card), as the JAX serve reports."""
    batch = _batch(prompts, device, patches)
    with torch.no_grad():
        hidden = forward_hidden(cfg, params, batch)
    q = quantize_activations(hidden.reshape(-1, hidden.shape[-1]), bits=8,
                             per_token=True).q
    s = float(subprecision_sparsity(q))
    b, plen = hidden.shape[:2]
    imp = evaluate_model(lm_shape_of(cfg), s, HardwareConfig(),
                         prefill_tokens=plen * b,
                         decode_batch=b).improvements()
    return {"hidden_sparsity": s, "costmodel": imp}


def serve_rank(rank: int, cfg: ModelConfig, params, prompts, mesh_shape,
               engine_kw, out_paths=None) -> Dict[str, object]:
    """One rank of a ``--mesh`` serve (a ``spawn_world`` rank function):
    this rank's engine on the (data, model) mesh over the whole tree
    ``params``, the prompts served. Returns the run's summary with
    ``step_mode``; rank 0 writes the metrics and trace files of
    ``out_paths`` (metrics, trace), if named."""
    cuda = torch.cuda.is_available() and engine_kw.get("device") != "cpu"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device("cpu"))
    mesh = make_mesh(*mesh_shape, device_type=device.type)
    eng = make_engine(cfg, params, mesh=mesh, **dict(engine_kw,
                                                      device=device))
    r = run_requests(eng, prompts, engine_kw["gen"])
    r["step_mode"] = eng.step_mode
    metrics, trace = out_paths or ("", "")
    if rank == 0 and metrics:
        with open(metrics, "w") as f:
            json.dump(eng.metrics_snapshot(), f, indent=1)
    if rank == 0 and trace:
        eng.obs.tracer.export_chrome(trace)
    return r


def mesh_serve(cfg: ModelConfig, params, prompts, mesh_shape,
               backend: str, device, out_paths=None,
               **engine_kw) -> List[Dict[str, object]]:
    """Serve ``prompts`` on a (data, model) mesh of spawned ranks (one
    process each; ``backend`` their collectives'); ``engine_kw`` are
    :func:`make_engine`'s sizes (``gen`` among them). Returns every
    rank's summary, rank by rank (their streams are equal: the engine
    checks after each step)."""
    d, m = mesh_shape
    return spawn_world(serve_rank, d * m, cfg, params, prompts, mesh_shape,
                       dict(engine_kw, device=device.type), out_paths,
                       backend=backend, device_type=device.type)


def _batch(prompts: List[List[int]], device,
           patches: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The model's batch: the prompts' tokens and, for a VLM, the patch
    embeddings that go in front of them."""
    batch = {"tokens": torch.tensor(prompts, dtype=torch.int32,
                                    device=device)}
    if patches is not None:
        batch["patches"] = patches
    return batch


def vlm_patches(cfg: ModelConfig, seed: int, batch: int,
                device) -> torch.Tensor:
    """A VLM's stub image prefix: (batch, n_prefix, D) standard normal
    patch embeddings in the compute dtype, drawn from ``seed`` with an
    explicit generator on ``device``. These are not the JAX serve's
    ``jax.random.PRNGKey(1)`` draws (the two generators differ); the
    parity tests hand the same numpy patches to both packages."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.n_prefix, cfg.d_model), generator=g,
                       device=device).to(cfg.cdtype)


class LegacySteps:
    """The fixed-batch path's compiled prefill and decode
    (``launch/graphs.py``) and the contiguous caches they run on, for one
    (cfg, batch, max_len) on one device. Handed back to
    :func:`legacy_serve`, a later serve of that shape reuses the caches,
    so its prefill replays the graph a second serve captured, as its
    decode does: a process that serves one shape again pays one graph
    launch a prefill."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, device):
        self.shape = (cfg, batch, max_len, torch.device(device))
        self.prefill = CompiledStep(S.make_serve_prefill_into(cfg), device)
        self.decode = CompiledStep(S.make_serve_decode(cfg), device)
        self.cache = None


def legacy_serve(cfg: ModelConfig, params, prompts: List[List[int]],
                 gen: int, device, patches: Optional[torch.Tensor] = None,
                 steps: Optional[LegacySteps] = None) -> Dict[str, object]:
    """The fixed-batch path: one prefill of the whole (equal-length)
    prompts, behind a VLM's ``patches`` (B, n_prefix, D), into contiguous
    caches of prefix + prompt + ``gen`` positions, then ``gen - 1``
    lockstep greedy decode steps, each step through a compiled step of
    ``steps`` (a new :class:`LegacySteps` if none is given). Returns the
    streams; ``prefill_s``, the caches' allocation (where ``steps`` has
    none yet) plus the prefill; ``prefill_call``, how the prefill ran
    (``eager``, ``warm-up``, ``capture`` or ``replay``: a first serve
    warms up, a second captures, later ones replay) and
    ``prefill_replay_s``, its time where it replayed (else None);
    ``decode_warmup_s`` (the steps before the decode's graph replays: its
    eager warm-up and its capture, or the first step where nothing is
    captured; none if no step would be left after them, or if an earlier
    serve of ``steps`` captured) and ``decode_step_s``, the mean of the
    ``decode_timed_steps`` after it."""
    batch = _batch(prompts, device, patches)
    b, plen = batch["tokens"].shape
    if patches is not None:
        plen += patches.shape[1]
    shape = (cfg, b, plen + gen, torch.device(device))
    steps = steps or LegacySteps(*shape)
    if steps.shape != shape:
        raise ValueError(f"these legacy steps serve {steps.shape[1:]} "
                         f"(batch, max_len, device), not {shape[1:]}")
    prefill, decode = steps.prefill, steps.decode

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    graphs = prefill.graphs
    t0 = time.perf_counter()
    if steps.cache is None:
        steps.cache = init_cache(cfg, b, plen + gen, device)
    cache = steps.cache
    tok = prefill(params, cache, *batch.values())
    sync()
    t_prefill = time.perf_counter() - t0
    call = ("eager" if not prefill.captures else
            "capture" if prefill.graphs > graphs else
            "replay" if graphs else "warm-up")
    out = [tok]
    n = gen - 1
    # the steps before the graph replays (eager warm-up, capture) are
    # timed apart, unless that would leave no step to time
    warm = 0 if decode.graphs else 2 if decode.captures else 1
    warm = warm if warm < n else 0
    t0 = t1 = time.perf_counter()
    for i in range(n):
        if i == warm:
            sync()
            t1 = time.perf_counter()
        pos = torch.full((b,), plen + i, dtype=torch.int32, device=device)
        tok, cache = decode(params, cache, tok, pos)
        out.append(tok)
    sync()
    t2 = time.perf_counter()
    return {"streams": torch.stack(out, 1).tolist(), "prefill_s": t_prefill,
            "prefill_call": call,
            "prefill_replay_s": t_prefill if call == "replay" else None,
            "decode_step_s": (t2 - t1) / max(1, n - warm),
            "decode_warmup_s": t1 - t0, "decode_steps": n,
            "decode_timed_steps": n - warm}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the CLI; returns the run's summary (its ``streams`` the greedy
    token streams)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--k-percent", type=float, default=50.0)
    ap.add_argument("--clip-l", type=float, default=-8.0)
    ap.add_argument("--clip-h", type=float, default=23.0)
    ap.add_argument("--no-clip", action="store_true")
    ap.add_argument("--mode", default="sparqle", choices=["sparqle", "dense"])
    ap.add_argument("--ckpt", default=None,
                    help="restore float params from this checkpoint dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="0 = size the pool to fit the whole batch")
    ap.add_argument("--token-budget", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--decode-slots", type=int, default=8)
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="self-speculative decoding: LSB4-only draft "
                         "window per verify cycle (0 = off)")
    ap.add_argument("--legacy", action="store_true",
                    help="fixed-batch serving path (no engine)")
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL mesh of ranks for the engine (e.g. "
                         "'1,2'): decode slots and pool pages shard over "
                         "data, weights and KV heads over model; streams "
                         "equal the single-device serve's")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collectives of the --mesh ranks: nccl (default "
                         "on a card; one card a rank) or gloo (shares the "
                         "cards, steps run eagerly; the CPU's)")
    ap.add_argument("--slo", action="append", default=[],
                    help="declarative SLO spec, repeatable and/or "
                         "comma-separated (e.g. --slo ttft:p95<0.25 "
                         "--slo queue_depth:p50<4): the engine watches the "
                         "signal's sliding-window percentile and reports "
                         "violations and burn rate")
    ap.add_argument("--attribute", action="store_true",
                    help="count each serving step's work from its shapes "
                         "(FLOPs, HBM bytes, collective bytes) and join it "
                         "with the measured step times: roofline and "
                         "cost-model drift gauges")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics-registry snapshot (JSON) here")
    ap.add_argument("--trace-out", default="",
                    help="write the Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    mesh_shape = (1, 1)
    if args.mesh:
        try:
            mesh_shape = tuple(int(v) for v in args.mesh.split(","))
            assert len(mesh_shape) == 2 and min(mesh_shape) >= 1
        except (ValueError, AssertionError):
            raise SystemExit(f"--mesh expects 'DATA,MODEL', got "
                             f"{args.mesh!r}")
        if args.legacy:
            raise SystemExit("--mesh drives the paged engine; it has no "
                             "effect on --legacy (drop one of the two)")
    if args.legacy and (args.metrics_out or args.trace_out):
        raise SystemExit("--metrics-out/--trace-out read the paged "
                         "engine's observability bundle; the --legacy "
                         "path has none (drop one of the two)")
    if args.legacy and (args.slo or args.attribute):
        raise SystemExit("--slo/--attribute drive the paged engine's "
                         "observability; the --legacy path has none "
                         "(drop one of the two)")
    slos = [slo for spec in args.slo for slo in parse_slo_list(spec)]
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.legacy:
        check_contiguous_support(cfg)
    else:
        try:
            check_paged_support(cfg)
        except NotImplementedError as e:
            raise SystemExit(f"{e}\n(this arch serves via --legacy only)")
    if cfg.family == "vlm" and args.prompt_len <= cfg.n_prefix:
        raise SystemExit(f"--prompt-len {args.prompt_len} must exceed "
                         f"{cfg.name}'s {cfg.n_prefix} image-prefix "
                         f"positions")
    device = resolve_device(args.device)
    ranks = mesh_shape[0] * mesh_shape[1]
    backend = (pick_backend(device, ranks, args.dist_backend)
               if ranks > 1 else None)
    t0 = time.perf_counter()
    quant_kw = dict(k_percent=args.k_percent, clip_l=args.clip_l,
                    clip_h=args.clip_h, enable_clipping=not args.no_clip,
                    tile_k=16 if args.smoke else 128, mode=args.mode)
    if args.ckpt:
        params = restore_served_params(cfg, args.ckpt, device, **quant_kw)
    else:
        params = build_served_params(cfg, args.seed, device, **quant_kw)
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{'restored' if args.ckpt else 'built'} and quantized "
          f"({args.mode}) on {device} in {time.perf_counter() - t0:.1f} s")
    prompts = synthetic_prompts(cfg, args.seed, args.batch, args.prompt_len)
    patches = None
    if cfg.family == "vlm":
        # the JAX serve's batch: n_prefix patches, then the first
        # prompt_len - n_prefix tokens of each prompt
        patches = vlm_patches(cfg, args.seed, args.batch, device)
        prompts = [p[:args.prompt_len - cfg.n_prefix] for p in prompts]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU, plain versions")
    if args.legacy:
        r = legacy_serve(cfg, params, prompts, args.gen, device, patches)
        print(f"generated {args.batch} x {args.gen} tokens; prefill "
              f"{r['prefill_s'] * 1e3:.1f} ms, "
              f"{r['decode_step_s'] * 1e3:.2f} ms/token over "
              f"{r['decode_timed_steps']} steps after a warm-up of "
              f"{r['decode_warmup_s'] * 1e3:.1f} ms ({where})")
        return _close(r, cfg, params, prompts, device, patches)
    engine_kw = dict(batch=args.batch, prompt_len=args.prompt_len,
                     gen=args.gen, page_size=args.page_size,
                     n_pages=args.n_pages, token_budget=args.token_budget,
                     prefill_chunk=args.prefill_chunk,
                     decode_slots=args.decode_slots,
                     spec_gamma=args.spec_gamma, slos=slos,
                     attribute=args.attribute)
    if ranks > 1:
        runs = mesh_serve(cfg, params, prompts, mesh_shape, backend, device,
                          (args.metrics_out, args.trace_out), **engine_kw)
        r = runs[0]
        print(f"serving on mesh {mesh_shape[0]}x{mesh_shape[1]} ({ranks} "
              f"ranks, {backend}, steps {r['step_mode']}): decode slots "
              f"and pool pages sharded over data, weights and KV heads "
              f"over model")
    else:
        eng = make_engine(cfg, params, device=device, **engine_kw)
        r = run_requests(eng, prompts, args.gen)
    print(f"engine: {r['requests']} requests, {r['tokens']} tokens in "
          f"{r['wall_s']:.2f} s ({r['tokens_per_s']:.1f} tok/s, "
          f"{r['steps']} steps; {where})")
    print(f"  TTFT  mean {r['ttft_mean_s'] * 1e3:.1f} ms  "
          f"p95 {r['ttft_p95_s'] * 1e3:.1f} ms")
    print(f"  TPOT  mean {r['tpot_mean_s'] * 1e3:.2f} ms/token")
    print(f"  MSB4 sparsity mean {r['act_sparsity'] * 100:.1f}%")
    agg = r["aggregate"]
    if "wire_compression_pct" in agg:
        print(f"  measured wire format: {agg['wire_compression_pct']:.1f}% "
              f"activation bytes saved vs dense int8")
    if "spec_acceptance_rate" in agg:
        print(f"  speculative: gamma={agg['spec_gamma']}, "
              f"{agg['spec_acceptance_rate'] * 100:.1f}% drafts accepted, "
              f"{agg['spec_tokens_per_step']:.2f} tokens/cycle")
    print(f"  pool: {agg['pool_utilization'] * 100:.0f}% pages in use at "
          f"drain, {agg['pool_evictions']} evictions")
    for phase, c in sorted((r["attribution"] or {}).items()):
        print(f"attributed {phase}: {c['flops'] / 1e6:.1f} MFLOP/step, "
              f"{c['hbm_bytes'] / 1e6:.1f} MB HBM/step, "
              f"{c['coll_bytes_total'] / 1e3:.1f} kB collectives "
              f"(counted in {c['compile_seconds']:.3f} s)")
        if c["steps"]:
            timed = " (timed: the whole draft+verify cycle)" \
                if c["cycle"] else ""
            print(f"  {phase}{timed}: {c['steps']} steps, mean "
                  f"{c['mean_step_s'] * 1e3:.3f} ms (byte floor "
                  f"{c['floor_s'] * 1e3:.3f} ms), achieved "
                  f"{c['bytes_per_s'] / 1e9:.2f} GB/s, memory util "
                  f"{c['memory_util']:.4f}, compute util "
                  f"{c['compute_util']:.5f} ({where})")
    for rep in r["slo"] or []:
        state = "VIOLATING" if rep["violating"] else "ok"
        print(f"  SLO {rep['slo']}: p{rep['percentile']:g} = "
              f"{rep['value']:.4g} {rep['unit']} (target "
              f"{rep['target']:g}) [{state}], {rep['violations']} "
              f"violation(s), burn rate {rep['burn_rate']:.2f}")
    if ranks == 1 and args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(eng.metrics_snapshot(), f, indent=1)
    if ranks == 1 and args.trace_out:
        eng.obs.tracer.export_chrome(args.trace_out)
    return _close(r, cfg, params, prompts, device)


def _close(r: Dict[str, object], cfg: ModelConfig, params, prompts,
           device, patches: Optional[torch.Tensor] = None
           ) -> Dict[str, object]:
    """Print the closing report and add it to the summary ``r``."""
    r.update(closing_report(cfg, params, prompts, device, patches))
    imp = r["costmodel"]
    print(f"MSB4 sub-precision sparsity of hidden activations: "
          f"{r['hidden_sparsity'] * 100:.1f}%")
    print("cost-model prediction at this sparsity (the paper's "
          f"accelerator): TTFT -{imp['ttft_latency_pct']:.1f}%, "
          f"TPOT -{imp['tpot_latency_pct']:.1f}%, "
          f"prefill E -{imp['prefill_energy_pct']:.1f}%, "
          f"decode E -{imp['decode_energy_pct']:.1f}%")
    return r


if __name__ == "__main__":
    main()

"""Serving driver on the SPARQLe quantized path (the paged engine).

Requests are admitted FCFS under a token budget into a paged packed-KV4
pool, prefill is chunked, decode slots are backfilled every step, and
every projection runs the fused encoder + dual-pass W4A8 matmul kernels
while decode attention runs the paged KV4 kernel. Weights are drawn from
``--seed`` on the device and quantized one layer at a time; prompts are
numpy tokens from the same seed. Prints per-request TTFT/TPOT, tokens/s,
the achieved MSB4 sparsity and the measured wire compression.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_paged_support
from repro_torch.models.schema import init_quantized_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.serving import (Engine, PoolConfig, SamplingParams,
                                 SchedulerConfig)
from repro_torch.serving.engine import resolve_device


def build_served_params(cfg: ModelConfig, seed: int, device, *,
                        k_percent: float = 50.0, clip_l: float = -8.0,
                        clip_h: float = 23.0, enable_clipping: bool = True,
                        tile_k: int = 128):
    """The SPARQLe served tree drawn from ``seed`` directly on ``device``."""
    return init_quantized_params(
        build_schema(cfg), seed, device, float_dtype=cfg.cdtype,
        w_bits=cfg.w_bits, k_percent=k_percent, clip_l=clip_l,
        clip_h=clip_h, enable_clipping=enable_clipping, tile_k=tile_k)


def make_prompts(cfg: ModelConfig, seed: int, batch: int,
                 prompt_len: int) -> List[List[int]]:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, prompt_len)).tolist()


def make_engine(cfg: ModelConfig, params, *, batch: int, prompt_len: int,
                gen: int, page_size: int = 16, n_pages: int = 0,
                token_budget: int = 128, prefill_chunk: int = 32,
                decode_slots: int = 8, device="cuda") -> Engine:
    """Engine sized like ``repro.launch.serve``: a block table that fits
    prompt + generation, and by default a pool that fits the batch."""
    pages_per_seq = -(-(prompt_len + gen) // page_size)
    return Engine(
        cfg, params,
        pool_config=PoolConfig(
            n_pages=n_pages or 1 + pages_per_seq * batch,
            page_size=page_size),
        sched_config=SchedulerConfig(
            max_decode_batch=min(batch, decode_slots),
            token_budget=token_budget, prefill_chunk=prefill_chunk,
            max_pages_per_seq=pages_per_seq),
        device=device)


def run_requests(eng: Engine, prompts: List[List[int]],
                 gen: int) -> Dict[str, object]:
    """Submit every prompt, drain the engine, and summarise the run."""
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
    }


def main(argv: Optional[List[str]] = None) -> None:
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="0 = size the pool to fit the whole batch")
    ap.add_argument("--token-budget", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--decode-slots", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics-registry snapshot (JSON) here")
    ap.add_argument("--trace-out", default="",
                    help="write the Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    check_paged_support(cfg)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    params = build_served_params(
        cfg, args.seed, device, k_percent=args.k_percent,
        clip_l=args.clip_l, clip_h=args.clip_h,
        enable_clipping=not args.no_clip,
        tile_k=16 if args.smoke else 128)
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, built and "
          f"quantized on {device} in {time.perf_counter() - t0:.1f} s")
    eng = make_engine(cfg, params, batch=args.batch,
                      prompt_len=args.prompt_len, gen=args.gen,
                      page_size=args.page_size, n_pages=args.n_pages,
                      token_budget=args.token_budget,
                      prefill_chunk=args.prefill_chunk,
                      decode_slots=args.decode_slots, device=device)
    r = run_requests(eng, make_prompts(cfg, args.seed, args.batch,
                                       args.prompt_len), args.gen)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU, plain versions")
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
    print(f"  pool: {agg['pool_utilization'] * 100:.0f}% pages in use at "
          f"drain, {agg['pool_evictions']} evictions")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(eng.metrics_snapshot(), f, indent=1)
    if args.trace_out:
        eng.obs.tracer.export_chrome(args.trace_out)


if __name__ == "__main__":
    main()

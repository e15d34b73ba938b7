"""End-to-end training entry point with checkpoint/restart and fault
injection (torch twin of ``repro.launch.train``).

Runs a registered token LM (full or ``--smoke`` config) on one device
with the reference's substrate: the synthetic packed data pipeline, the
microbatched AdamW train step (``launch/steps.py``), sync or async
checkpoints, the restartable step loop with its straggler deadline,
optional injected faults and optional int8 gradient compression. Mesh
training (``--data-axis``/``--model-axis`` above 1) is not ported yet.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --steps 12 --inject-fail 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --smoke --steps 50 --ckpt-dir ck --resume auto

The device defaults to ``cuda`` and raises without a card. Each logged
step reads its loss to the host, so the ms/step it prints and the
deadline cover the step's device work.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.distributed.fault import FaultInjector, RestartableLoop
from repro_torch.launch import steps as S
from repro_torch.models.schema import init_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.serving.engine import resolve_device


def build_state(cfg: ModelConfig, ocfg: OptConfig, seed: int,
                device) -> S.TrainState:
    """f32 master params drawn from ``seed`` on ``device`` and zeroed
    moments."""
    params = init_params(build_schema(cfg), seed, device)
    return S.TrainState(params=params, opt=init_opt_state(params, ocfg))


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--inject-fail", type=int, default=None,
                    help="inject a step failure at this step (recovery demo)")
    ap.add_argument("--deadline-s", type=float, default=1e9)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encoder", "vlm"):
        raise SystemExit(f"{args.arch}: the CLI trains token LMs; non-LM "
                         "training needs its frontend stub (see examples/)")
    if args.data_axis > 1 or args.model_axis > 1:
        raise NotImplementedError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            "mesh training is not ported yet (ROADMAP A9); the port trains "
            "on one device")
    device = resolve_device(args.device)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                     total_steps=args.steps)
    knobs = S.TrainKnobs(microbatch=args.microbatch,
                         ce_chunk=min(512, args.seq),
                         compress_pod_grads=args.compress_pod_grads)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    step_fn = S.make_train_step(cfg, ocfg, knobs)
    state = build_state(cfg, ocfg, args.seed, device)

    start = 0
    if args.resume == "auto":
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = store.place_like(
                store.restore(args.ckpt_dir, latest, state), state)
            start = latest
            print(f"resumed from step {start}")

    hist = []
    t0 = time.time()

    def make_batch(step):
        return shard_batch(data.batch_at(step), device)

    def logged_step(st, batch):
        st, m = step_fn(st, batch)
        hist.append(float(m["loss"]))    # the step's device work ends here
        n = len(hist)
        if n % args.log_every == 0:
            dt = (time.time() - t0) / n
            print(f"step {start + n:5d} loss {hist[-1]:.4f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        return st, m

    injector = None
    if args.inject_fail is not None:
        injector = FaultInjector(plan={args.inject_fail: "fail"})

    loop = RestartableLoop(
        logged_step, make_batch, args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector,
        deadline_s=args.deadline_s, async_ckpt=args.async_ckpt)
    state, metrics = loop.run(state, start, args.steps)

    print(f"done: {loop.report}")
    print(f"final loss {hist[-1]:.4f} (first {hist[0]:.4f})")
    return {"losses": hist, "report": loop.report, "state": state,
            "metrics": metrics, "start": start,
            "ms_per_step": (time.time() - t0) / max(1, len(hist)) * 1e3}


if __name__ == "__main__":
    main()

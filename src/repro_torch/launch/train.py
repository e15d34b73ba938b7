"""End-to-end training entry point with checkpoint/restart and fault
injection (torch twin of ``repro.launch.train``).

Runs a registered token LM (full or ``--smoke`` config) on one device or
on a ("data", "model") mesh of ``--data-axis`` x ``--model-axis`` ranks,
with the reference's substrate: the synthetic packed data pipeline, the
microbatched AdamW train step (``launch/steps.py``), sync or async
checkpoints, the restartable step loop with its straggler deadline,
optional injected faults and optional int8 gradient compression.

On a mesh each rank is a process (``launch/mesh.spawn_world``; its
collectives ``--dist-backend``, as ``serve --mesh`` takes it): the state
is sharded over data (FSDP) and in the Megatron cut over model, with the
routed experts on the expert axis; each rank draws its slices of the
one-device init leaf by leaf, and no rank holds the whole tree. A
checkpoint is the whole tree in the one-device format, written by rank
0, so it restores at any mesh shape. Rank 0's lines are printed when the
world ends, and :func:`main` returns what the one-device run returns,
with the state gathered whole. At model ways > 1 GQA, MLA and SSD
mixers are cut by head (an SSD mixer's ``w_in`` and conv by segment,
``distributed/sharding.py``): the heads, KV heads, SSD heads and FFN
widths must divide, and SSD B/C groups divide or are one (else
ValueError, before any rank starts). Under
``torch.use_deterministic_algorithms`` the ranks run deterministic too.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --steps 12 --inject-fail 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        deepseek-moe-16b --smoke --device cpu --data-axis 2 --model-axis 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        deepseek-v3-671b --smoke --device cpu --model-axis 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --smoke --device cpu --data-axis 2 --model-axis 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --smoke --steps 50 --ckpt-dir ck --resume auto

The device defaults to ``cuda`` and raises without a card; a mesh on a
card takes a card a rank under NCCL, or ``--dist-backend gloo`` to share
one. Each logged step reads its loss to the host, so the ms/step it
prints and the deadline cover the step's device work.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, data_rows,
                                       shard_batch)
from repro_torch.distributed.fault import FaultInjector, RestartableLoop
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_mesh, pick_backend, spawn_world
from repro_torch.models.model import check_train_mesh
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


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collectives of a mesh's ranks: nccl (default on a "
                         "card; one card a rank) or gloo (shares the cards; "
                         "the CPU's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' trains on the CPU")
    return ap


def _train(args, cfg: ModelConfig, device, tm: Optional[S.TrainMesh],
           say: Callable[[str], None]) -> Dict[str, object]:
    """The run on one device (``tm`` None) or on this rank of a mesh."""
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                     total_steps=args.steps)
    knobs = S.TrainKnobs(microbatch=args.microbatch,
                         ce_chunk=min(512, args.seq),
                         compress_pod_grads=args.compress_pod_grads)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    step_fn = S.make_train_step(cfg, ocfg, knobs, mesh=tm)
    state = (build_state(cfg, ocfg, args.seed, device) if tm is None
             else tm.build_state(ocfg, args.seed, device))

    start = 0
    if args.resume == "auto":
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = (store.restore_sharded(args.ckpt_dir, latest, state, tm)
                     if tm is not None else store.place_like(
                         store.restore(args.ckpt_dir, latest, state), state))
            start = latest
            say(f"resumed from step {start}")

    hist: List[float] = []
    t0 = time.time()

    def make_batch(step):
        if tm is None:
            return shard_batch(data.batch_at(step), device)
        c = tm.layout.coords
        return shard_batch(data.batch_at(step), device,
                           data_rank=c.data_rank, data_ways=c.data_ways,
                           microbatch=args.microbatch)

    def logged_step(st, batch):
        st, m = step_fn(st, batch)
        hist.append(float(m["loss"]))    # the step's device work ends here
        n = len(hist)
        if n % args.log_every == 0:
            dt = (time.time() - t0) / n
            say(f"step {start + n:5d} loss {hist[-1]:.4f} "
                f"({dt*1e3:.0f} ms/step)")
        return st, m

    injector = None
    if args.inject_fail is not None:
        injector = FaultInjector(plan={args.inject_fail: "fail"})

    loop = RestartableLoop(
        logged_step, make_batch, args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector,
        deadline_s=args.deadline_s, async_ckpt=args.async_ckpt, mesh=tm)
    state, metrics = loop.run(state, start, args.steps)

    say(f"done: {loop.report}")
    say(f"final loss {hist[-1]:.4f} (first {hist[0]:.4f})")
    return {"losses": hist, "report": loop.report, "state": state,
            "metrics": metrics, "start": start,
            "ms_per_step": (time.time() - t0) / max(1, len(hist)) * 1e3}


def _mesh_rank(rank: int, argv: List[str], deterministic: bool):
    """One rank of a mesh run (a ``spawn_world`` rank function): rank 0
    returns the run's result with the state gathered whole (as host
    arrays) and its lines; the others None."""
    torch.use_deterministic_algorithms(deterministic)
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device.startswith("cuda") else torch.device("cpu"))
    tm = S.TrainMesh(cfg, make_mesh(args.data_axis, args.model_axis,
                                    device_type=device.type))
    lines: List[str] = []
    r = _train(args, cfg, device, tm,
               lines.append if rank == 0 else (lambda _: None))
    whole = tm.gather(r["state"])
    if rank != 0:
        return None
    return dict(r, state=store.to_host(whole), lines=lines,
                metrics={k: float(v) for k, v in r["metrics"].items()})


def main(argv=None) -> Dict[str, object]:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encoder", "vlm"):
        raise SystemExit(f"{args.arch}: the CLI trains token LMs; non-LM "
                         "training needs its frontend stub (see examples/)")
    if min(args.data_axis, args.model_axis) < 1:
        raise ValueError(f"mesh {args.data_axis}x{args.model_axis}")
    device = resolve_device(args.device)
    ranks = args.data_axis * args.model_axis
    if ranks == 1:
        return _train(args, cfg, device, None,
                      lambda line: print(line, flush=True))
    # refuse what the mesh cannot run before any rank starts
    check_train_mesh(cfg, args.model_axis)
    data_rows(args.batch, args.microbatch, 0, args.data_axis)
    backend = pick_backend(device, ranks, args.dist_backend)
    r = spawn_world(_mesh_rank, ranks, argv,
                    torch.are_deterministic_algorithms_enabled(),
                    backend=backend, device_type=device.type)[0]
    for line in r.pop("lines"):
        print(line, flush=True)
    return dict(r, state=store.from_host(r["state"]),
                metrics={k: torch.tensor(v) for k, v in
                         r["metrics"].items()})


if __name__ == "__main__":
    main()

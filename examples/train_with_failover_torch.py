"""Train a small LM with full fault tolerance on the PyTorch/CUDA port
(twin of ``examples/train_with_failover.py``).

Demonstrates the port's training substrate end to end: synthetic packed
data, microbatched AdamW, async checkpointing, an injected mid-run
failure with automatic restore+replay, and a final resume from the
newest checkpoint — the machinery ``repro_torch.launch.train`` runs.

Run:  PYTHONPATH=src python examples/train_with_failover_torch.py  (card)
      PYTHONPATH=src python examples/train_with_failover_torch.py \\
          --device cpu --steps 20
      (--d-model 512 for the full config; the default keeps CI-sized
       wall time)
"""
import argparse
import shutil
import sys
import tempfile

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.distributed.fault import FaultInjector, RestartableLoop
from repro_torch.launch import steps as S
from repro_torch.models.schema import init_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.serving.engine import resolve_device

CKPT_EVERY = 20


def demo_config(d_model: int, layers: int,
                dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="demo-lm", family="transformer", n_layers=layers,
        d_model=d_model, n_heads=8, n_kv_heads=4,
        d_ff=int(2.75 * d_model), vocab=2048, dtype=dtype)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="compute dtype over the f32 master params")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' trains on the CPU")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = demo_config(args.d_model, args.layers, args.dtype)
    schema = build_schema(cfg)

    ocfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    knobs = S.TrainKnobs(microbatch=args.batch // 2, ce_chunk=64)
    step_fn = S.make_train_step(cfg, ocfg, knobs)
    params = init_params(schema, args.seed, dev)
    n_params = sum(t.numel() for t in store.flatten(params))
    print(f"model: {n_params/1e6:.1f}M params")
    state = S.TrainState(params, init_opt_state(params, ocfg))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))

    ckdir = tempfile.mkdtemp(prefix="repro_torch_failover_")
    losses = []

    def logged(st, batch):
        st, m = step_fn(st, batch)
        losses.append(float(m["loss"]))
        if len(losses) % 10 == 0:
            print(f"  step {len(losses):4d} loss {losses[-1]:.4f}")
        return st, m

    def make_batch(i):
        return shard_batch(data.batch_at(i), dev)

    fail_at = args.steps // 2
    print(f"training {args.steps} steps; injecting a failure at step "
          f"{fail_at} (checkpoint every {CKPT_EVERY}, async)")
    loop = RestartableLoop(
        logged, make_batch, ckdir, ckpt_every=CKPT_EVERY, async_ckpt=True,
        injector=FaultInjector(plan={fail_at: "fail"}))
    try:
        state, _ = loop.run(state, 0, args.steps)
        print(f"loop report: {loop.report}")
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(replayed steps included)")

        # resume-from-checkpoint path (what --resume auto does)
        latest = store.latest_step(ckdir)
        state2 = store.restore(ckdir, latest, state)
        equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            store.flatten(state2.params), store.flatten(state.params)))
        print(f"restored step {latest}; params bit-identical: {equal}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"n_params": n_params, "losses": losses, "report": loop.report,
            "restored_step": latest, "restored_equal": equal,
            "fail_at": fail_at}


if __name__ == "__main__":
    main(sys.argv[1:])

"""Where a full-size train step's time goes on the card.

    python tools/train_probe.py [starcoder2-3b] [hubert-xlarge] [--steps 2]

For each arch, at ``chip_smoke.py`` phase 18's shapes (starcoder2-3b: 8 x
128 tokens, microbatches of 4, CE chunks of 128; hubert-xlarge: 8 x 128
frames), weights from seed 0: two warm steps, then ``--steps`` steps
with the gradient half (``launch/steps.make_accum_grads``: forward,
remat, backward) and the AdamW update timed apart (host clock around
synchronized calls), then one step under ``torch.profiler``: its device
time by kernel group and its share of the step's wall. The profiler's
table goes to ``train_probe_<arch>.txt`` in ``chip_smoke.OUT``. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as C  # noqa: E402

GROUPS = (("gemm", "cuBLAS"), ("gemv", "cuBLAS"), ("cutlass", "cuBLAS"),
          ("nvjet", "cuBLAS"),
          ("sm90_", "cuBLAS"), ("reduce", "PyTorch reduce"),
          ("elementwise", "PyTorch elementwise"), ("copy", "PyTorch copy"),
          ("index", "PyTorch index/scatter"),
          ("scatter", "PyTorch index/scatter"),
          ("gather", "PyTorch index/scatter"), ("cat", "PyTorch cat"),
          ("softmax", "PyTorch softmax"), ("sort", "PyTorch sort"))


def setup(dev, arch: str):
    """(cfg, state, batch, knobs, ocfg) at phase 18's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import OptConfig
    cfg = get_config(arch)
    ocfg = OptConfig(warmup_steps=1, total_steps=10)
    state = build_state(cfg, ocfg, 0, dev)
    if cfg.family == "encoder":
        b, s = C.ENCODER_TRAIN["batch"], C.ENCODER_TRAIN["seq"]
        g = torch.Generator(device=dev).manual_seed(0)
        batch = {"frames": torch.randn((b, s, cfg.d_model), generator=g,
                                       device=dev).to(cfg.cdtype),
                 "targets": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                          device=dev, dtype=torch.int32)}
        knobs = S.TrainKnobs(ce_chunk=s)
    else:
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=C.TRAIN["seq"],
                                      global_batch=C.TRAIN["batch"], seed=0))
        batch = shard_batch(data.batch_at(0), dev)
        knobs = S.TrainKnobs(**C.TRAIN_KNOBS)
    return cfg, state, batch, knobs, ocfg


def probe(dev, arch: str, steps: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import adamw_update
    cfg, state, batch, knobs, ocfg = setup(dev, arch)
    step = S.make_train_step(cfg, ocfg, knobs)
    grads_fn = S.make_accum_grads(cfg, knobs)
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    split = {"grads": 0.0, "adamw": 0.0}
    for _ in range(steps):
        t0 = time.perf_counter()
        _, _, grads = grads_fn(state.params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _ = adamw_update(state.params, grads, state.opt, ocfg)
        torch.cuda.synchronize()
        split["grads"] += t1 - t0
        split["adamw"] += time.perf_counter() - t1
        state = S.TrainState(params, opt)
        del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in ka if e.device_type == DeviceType.CUDA]
    total = sum(us for _, us, _ in rows)
    groups = {}
    for key, us, count in rows:
        group = next((g for pat, g in GROUPS if pat in key.lower()), "other")
        t, c = groups.get(group, (0.0, 0))
        groups[group] = (t + us, c + count)
    (C.OUT / f"train_probe_{arch}.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=60))
    print(f"{arch} ({cfg.n_layers}L d={cfg.d_model}) train step: grads "
          f"(forward, remat, backward) {split['grads'] / steps * 1e3:.1f} "
          f"ms, AdamW {split['adamw'] / steps * 1e3:.1f} ms (mean of "
          f"{steps}, synchronized); one profiled step: wall "
          f"{wall * 1e3:.1f} ms, device time {total / 1e3:.1f} ms "
          f"({total / 1e3 / (wall * 1e3):.3f} of the wall), "
          f"{sum(c for _, _, c in rows)} kernels; "
          + "; ".join(f"{g} {t / 1e3:.1f} ms ({c} kernels, {t / total:.3f})"
                      for g, (t, c) in sorted(groups.items(),
                                              key=lambda kv: -kv[1][0])),
          flush=True)
    del state, batch, step, grads_fn
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*",
                    default=[C.TRAIN_LM, C.TRAIN_ENCODER])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.OUT.mkdir(exist_ok=True)
    print(C.nvidia_smi_line(), flush=True)
    for arch in args.archs:
        probe(dev, arch, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a fixed-batch (``serve --legacy``) arch's card run parts from its
CPU run, and where its decode step's device time goes, on one card.

    python tools/legacy_probe.py trace jamba-v0.1-52b [--seeds 0,1,2]
    python tools/legacy_probe.py profile mamba2-2.7b [--steps 10]

``trace``: ``chip_smoke.legacy_cross_check``'s 2-layer f32 model
(``LEGACY_XC``'s cut, weights drawn on the card from the seed): the
prefill and ``LEGACY_XC_GEN - 1`` decode steps on the CPU (plain
versions, greedy) and on the card (kernels) fed the CPU's tokens. Prints
per step the logits' max difference over max |logit|, both argmaxes and
the CPU's top-1 minus top-2 logit; per layer and call the output's max
difference; per MoE router call the tokens whose expert ids differ and
the CPU's 2nd-3rd and 1st-2nd logit gaps.

``profile``: the arch at full width and depth (``chip_smoke.SSD_SERVE``'s
batch and lengths), its decode step captured as a CUDA graph after a
prefill, then ``--steps`` replays under ``torch.profiler``: device time a
step by kernel, grouped (the hand-written kernels by name, cuBLAS, and
PyTorch's elementwise, reduce, copy and other kernels), written in full
to ``chiprun_out/legacy_probe_<arch>.txt``.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as C  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qlinear import tree_to  # noqa: E402
from repro_torch.launch.serve import (build_served_params,  # noqa: E402
                                      make_prompts)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402


def trace(dev, arch: str, seed: int) -> None:
    over, n = C.LEGACY_XC[arch]
    gen = C.LEGACY_XC_GEN
    cfg = get_config(arch).replace(n_layers=2, dtype="float32", **over)
    rec = {}
    router, dec, full = (moe_lib.router, M._apply_layer_decode,
                         M._apply_layer_full)

    def rec_router(x, w, rt, k):
        v, i = router(x, w, rt, k)
        rec.setdefault("router", []).append(((x.float() @ w.float()).cpu(),
                                             i.cpu()))
        return v, i

    def rec_layer(fn):
        def call(cfg, ld, p, x, *args):
            out = fn(cfg, ld, p, x, *args)
            rec.setdefault("layer", []).append(
                (f"{ld.mixer}+{ld.ffn}", out[0].float().cpu()))
            return out
        return call

    moe_lib.router = rec_router
    M._apply_layer_decode, M._apply_layer_full = rec_layer(dec), \
        rec_layer(full)
    try:
        params = build_served_params(cfg, seed, dev)
        prompts = make_prompts(cfg, seed + 1, 2, n)
        runs, fed = {}, None
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            rec.clear()
            tree = params if name == "cuda" else tree_to(params, device)
            batch = {"tokens": torch.tensor(prompts, dtype=torch.int32,
                                            device=device)}
            with torch.no_grad():
                logits, cache = M.prefill(cfg, tree, batch, max_len=n + gen)
                steps = [logits.float().cpu()]
                for i in range(gen - 1):
                    tok = steps[-1].argmax(-1) if fed is None else fed[:, i]
                    pos = torch.full((2,), n + i, dtype=torch.int32,
                                     device=device)
                    logits, cache = M.decode_step(
                        cfg, tree, cache, tok.to(device, torch.int32), pos)
                    steps.append(logits.float().cpu())
            runs[name] = (torch.stack(steps, 1), dict(rec))
            fed = runs["cpu"][0].argmax(-1)
            del tree, cache
    finally:
        moe_lib.router, M._apply_layer_decode, M._apply_layer_full = (
            router, dec, full)
    (lp, rp), (lc, rc) = runs["cpu"], runs["cuda"]
    top2 = lp.topk(2, -1).values
    rel = [((lc[:, t] - lp[:, t]).abs().max()
            / lp[:, t].abs().max()).item() for t in range(gen)]
    print(f"{arch} seed {seed}: max |dlogit| / max |logit| by step "
          f"{[round(r, 5) for r in rel]}; argmax cpu {lp.argmax(-1).tolist()}"
          f" card {lc.argmax(-1).tolist()}; cpu top-1 minus top-2 "
          f"{[[round(g, 4) for g in row] for row in (top2[..., 0] - top2[..., 1]).tolist()]}",
          flush=True)
    for (tag, a), (_, b) in zip(rp["layer"], rc["layer"]):
        print(f"  layer {tag} {tuple(a.shape)}: max |d| "
              f"{(a - b).abs().max().item():.3g} of max "
              f"{a.abs().max().item():.3g}")
    for i, ((la, ia), (_, ib)) in enumerate(zip(rp.get("router", []),
                                                rc.get("router", []))):
        srt = la.sort(-1, descending=True).values
        differ = (ia != ib).any(-1)
        same_set = (ia.sort(-1).values == ib.sort(-1).values).all(-1)
        print(f"  router call {i} ({ia.shape[0]} tokens): ids differ on "
              f"{int(differ.sum())} tokens ({int((differ & same_set).sum())}"
              f" of them the same set in another order); min 2nd-3rd gap "
              f"{(srt[:, 1] - srt[:, 2]).min().item():.3g}, min 1st-2nd "
              f"gap {(srt[:, 0] - srt[:, 1]).min().item():.3g}", flush=True)


GROUPS = (("sparqle_matmul", "hand-written matmul"),
          ("sparqle_encode", "hand-written encoder"),
          ("kv_attention", "hand-written attention"),
          ("gemm", "cuBLAS"), ("gemv", "cuBLAS"), ("cutlass", "cuBLAS"),
          ("reduce", "PyTorch reduce"), ("elementwise", "PyTorch elementwise"),
          ("copy", "PyTorch copy"), ("cat", "PyTorch cat"))


def profile(dev, arch: str, steps: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from repro_torch.launch import steps as S
    from repro_torch.launch.graphs import CompiledStep
    cfg = get_config(arch)
    b, n, gen = (C.SSD_SERVE["batch"], C.SSD_SERVE["tokens"],
                 C.SSD_SERVE["gen"])
    params = build_served_params(cfg, 0, dev)
    batch = {"tokens": torch.tensor(make_prompts(cfg, 0, b, n),
                                    dtype=torch.int32, device=dev)}
    tok, cache = S.make_serve_prefill(cfg, n + gen)(params, batch)
    decode = CompiledStep(S.make_serve_decode(cfg), dev)
    pos = torch.full((b,), n, dtype=torch.int32, device=dev)
    for _ in range(3):          # eager warm-up, capture, one replay
        tok, cache = decode(params, cache, tok, pos)
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok, cache = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
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
    (C.OUT / f"legacy_probe_{arch}.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=60))
    print(f"{arch} decode replay, {steps} steps under torch.profiler: "
          f"device time {total / steps / 1e3:.3f} ms a step, "
          f"{sum(c for _, _, c in rows) / steps:.0f} kernels a step; "
          + "; ".join(f"{g} {t / steps / 1e3:.3f} ms ({c / steps:.0f} "
                      f"kernels, {t / total:.3f})"
                      for g, (t, c) in sorted(groups.items(),
                                              key=lambda kv: -kv[1][0])),
          flush=True)
    del params, cache
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["trace", "profile"])
    ap.add_argument("arch")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("legacy_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.OUT.mkdir(exist_ok=True)
    print(C.nvidia_smi_line(), flush=True)
    kernels.build_all()
    if args.what == "trace":
        for seed in (int(s) for s in args.seeds.split(",")):
            trace(dev, args.arch, seed)
    else:
        profile(dev, args.arch, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

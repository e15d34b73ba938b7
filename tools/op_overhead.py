"""Host time a kernel launch costs by each route through its wrapper.

    python tools/op_overhead.py [--calls 2000] [--repeats 5]

Row 1's fused encoder (``sparqle_encode_fused``, no PBM plane) at M = 8,
K = 4096, bf16, the decode projection's shape, called in a loop of
``--calls`` calls, the card synchronised at the loop's end: host wall
time a call, the best of ``--repeats`` loops, by three routes:

- ``wrapper``: the public wrapper on a CUDA tensor outside any trace
  (its checks, then the entry's implementation called directly);
- ``op``: the same entry's ``torch.library`` custom op (the dispatch a
  trace on meta tensors records; every launch took it when the op sat
  on the serving path);
- ``impl``: the entry's implementation alone (output allocation and the
  ctypes launch).

The kernel takes ~5 us on the card, so each loop is bound by the host.
Prints the card and one JSON object (us a call by route). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    from repro_torch import kernels
    from repro_torch.kernels import sparqle_encode as SE
    kernels.build_all()
    dev = torch.device("cuda", 0)
    x = torch.randn((8, 4096), device=dev).to(torch.bfloat16)
    routes = {
        "wrapper": lambda: SE.sparqle_encode_fused(x, with_pbm=False),
        "op": lambda: SE.FUSED_OP.op(x, None, None, 0, 0, False),
        "impl": lambda: SE.FUSED_OP.__wrapped__(x, None, None, 0, 0, False),
    }
    us = {}
    for name, fn in routes.items():
        best = float("inf")
        for _ in range(args.repeats):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / args.calls)
        us[name] = best * 1e6
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"us_per_call": us, "calls": args.calls,
                      "repeats": args.repeats}))


if __name__ == "__main__":
    main()

"""Compare the eager serve of two checkouts on one card, in turns.

    python tools/ab_eager.py PARENT_DIR [CHANGE_DIR] [--serves 2] \
        [--rounds 1]

Each checkout's own ``chip_smoke.py`` builds granite-8b at full width
and depth (served weights drawn from seed 0) and serves phase 4's
prompts through an engine with its steps eager (``disable_graphs()``,
the eager side of phase 4b) in a fresh process: one warm serve, then
``--serves`` timed ones. The processes run in the order A B B A,
``--rounds`` times, so that a drift of the card or of the host falls on
both sides alike. Prints one JSON line per process (TPOT and TTFT means
in ms of each timed serve), then the card and the median per side. The
engine's time is the host's as much as the card's: this measures what
the Python around each kernel launch costs. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, torch
import chip_smoke as C
from repro_torch import kernels
from repro_torch.launch.graphs import disable_graphs
from repro_torch.launch.serve import make_engine, run_requests
torch.backends.cuda.matmul.allow_tf32 = False
kernels.build_all()
dev = torch.device("cuda", 0)
cfg, params, prompts, _ = C.granite(dev, 0)
eng = make_engine(cfg, params, **C.SERVE, page_size=16, token_budget=128,
                  prefill_chunk=32, decode_slots=8, device=dev)
out = []
with disable_graphs():
    for i in range(1 + int(sys.argv[1])):
        r = run_requests(eng, prompts, C.SERVE["gen"])
        out.append({"tpot_ms": r["tpot_mean_s"] * 1e3,
                    "ttft_ms": r["ttft_mean_s"] * 1e3})
print(json.dumps(out[1:]))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=".")
    ap.add_argument("--serves", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    tpot = {side: [] for side in trees}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            tree = trees[side]
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, str(args.serves)], cwd=tree,
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise SystemExit(f"{side}: {proc.stderr[-3000:]}")
            serves = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, "serves": serves}), flush=True)
            tpot[side] += [s["tpot_ms"] for s in serves]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({side: {"tpot_ms_median": statistics.median(v),
                             "tpot_ms": v} for side, v in tpot.items()}))


if __name__ == "__main__":
    main()

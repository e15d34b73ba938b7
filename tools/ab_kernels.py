"""Compare the kernel times of two checkouts on one card, in turns.

    python tools/ab_kernels.py PARENT_DIR [CHANGE_DIR] \
        [--checks check_attention,check_verify_attention] [--rounds 2]

Each checkout's own ``chip_smoke.py`` phase-3 checks build, check and
time its kernels (CUDA-graph replay timed with CUDA events) in a fresh
process, on the same inputs (each check gets a generator seeded 0).
A row's timed shapes (its ``detail`` entries with M, K (and N), or with a
``key`` such as the attention rows' long context) are compared too,
where both checkouts time them. The
processes run in the order A B B A, ``--rounds`` times, so that a drift
of the card falls on both sides alike. Prints one JSON line per process,
then the card and the median per check and side. Needs a CUDA card.
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
kernels.build_all()
dev = torch.device("cuda", 0)
peaks = C.peaks_for(C.nvidia_smi_line().split(",")[0])
out = {}
for name in sys.argv[1].split(","):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = getattr(C, name)(dev, gen, peaks)
    for r in rows if isinstance(rows, list) else [rows]:
        key = f"{name}:{r['name']}" if isinstance(rows, list) else name
        out[key] = r["ms"]
        for d in r.get("detail", []):   # every timed shape of the row
            if "M" in d:   # the encoder's shapes have no N
                out[f"{key}@" + ",".join(
                    f"{a}={d[a]}" for a in ("M", "K", "N") if a in d)] = \
                    d["ms"]
            elif "key" in d:
                out[f"{key}@{d['key']}"] = d["ms"]
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=".")
    ap.add_argument("--checks", default="check_attention,"
                                        "check_verify_attention")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    times = {side: {} for side in trees}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            r = subprocess.run([sys.executable, "-c", CHILD, args.checks],
                               cwd=trees[side], capture_output=True,
                               text=True)
            if r.returncode:
                sys.exit(f"{side} ({trees[side]}) failed:\n{r.stderr}")
            ms = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, "ms": ms}), flush=True)
            for check, t in ms.items():
                times[side].setdefault(check, []).append(t)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    for check in times["parent"]:
        if check not in times["change"]:
            continue
        p = statistics.median(times["parent"][check])
        c = statistics.median(times["change"][check])
        print(f"{check}: parent median {p * 1e3:.2f} us, change median "
              f"{c * 1e3:.2f} us ({(c / p - 1) * 100:+.1f}%), parent runs "
              f"{[round(t * 1e3, 2) for t in times['parent'][check]]}, "
              f"change runs "
              f"{[round(t * 1e3, 2) for t in times['change'][check]]}")


if __name__ == "__main__":
    main()

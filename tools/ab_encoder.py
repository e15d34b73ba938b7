"""Time the encoder of two checkouts on one card, in turns.

    python tools/ab_encoder.py PARENT_DIR [CHANGE_DIR] [--rounds 2]
                               [--decode granite-8b]

Each process imports one checkout's ``repro_torch`` (its kernels built
from its own ``csrc``) and times it with this checkout's
``chip_smoke.encoder_ab_times``, which calls the public entries alone:
the launch floor, row 1 at ``ENCODE_TIMED``, rows 1q and 2 and the
scale-taking encoder at M = 8, K = 4096, the batched encoders at the
serve's routing and with every expert live. So both sides are timed at
the same shapes on the same inputs (seeded 0), though the parent's smoke
times fewer. The processes run in the order A B B A, ``--rounds``
times; prints one JSON line per process, the card, then per shape the
medians, the change's ratio to the parent's and each over its launch
floor; writes the same to ``chiprun_out/ab_encoder.json``. ``--decode
ARCH`` then runs this checkout's ``tools/legacy_probe.py profile ARCH``
on each checkout's package, in the same order: the arch's fixed-batch
decode step replayed as a CUDA graph, its time and the device time of
each kernel group (the encoder's among them) in the step. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch import kernels
sys.path.insert(0, sys.argv[2])
import chip_smoke as C
import repro_torch
assert repro_torch.__file__.startswith(sys.argv[1]), repro_torch.__file__
kernels.build_all()
print(json.dumps(C.encoder_ab_times(torch.device("cuda", 0))))
"""


DECODE = r"""
import runpy, sys
tree, root, arch = sys.argv[1:4]
sys.path.insert(0, tree + "/src")
import repro_torch
sys.argv = ["legacy_probe.py", "profile", arch, "--steps", "20"]
runpy.run_path(root + "/tools/legacy_probe.py", run_name="__main__")
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(ROOT))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--decode", default="")
    args = ap.parse_args()
    trees = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    times = {side: {} for side in trees}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            r = subprocess.run(
                [sys.executable, "-c", CHILD, str(trees[side]), str(ROOT)],
                cwd=trees[side], capture_output=True, text=True)
            if r.returncode:
                sys.exit(f"{side} ({trees[side]}) failed:\n{r.stderr}")
            ms = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, "ms": ms}), flush=True)
            for shape, t in ms.items():
                times[side].setdefault(shape, []).append(t)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    med = {side: {shape: statistics.median(ts) for shape, ts in t.items()}
           for side, t in times.items()}
    report = {"card": card, "runs": times, "median": med}
    for shape, p in med["parent"].items():
        c = med["change"][shape]
        line = (f"{shape}: parent median {p * 1e3:.2f} us, change median "
                f"{c * 1e3:.2f} us (change/parent {c / p:.3f})")
        if shape != "floor":
            line += (f", over the floor parent {p / med['parent']['floor']:.2f}"
                     f"x, change {c / med['change']['floor']:.2f}x")
        print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_encoder.json").write_text(json.dumps(report, indent=1))
    for side in ("parent", "change", "change", "parent") if args.decode \
            else ():
        r = subprocess.run([sys.executable, "-c", DECODE, str(trees[side]),
                            str(ROOT), args.decode], cwd=trees[side],
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"{side} decode failed:\n{r.stderr}")
        print(f"{side}: {r.stdout.strip().splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()

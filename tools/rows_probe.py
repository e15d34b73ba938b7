"""The expert-batched matmul against the order of its live experts, on one
card.

    python tools/rows_probe.py [--rounds 7]

Times ``sparqle_matmul`` on expert-batched operands with ``rows`` (the
dual pass, C = 1: decode's capacity) in one process with
``chip_smoke.time_ms``, three ways on the same live experts' weights:
  * ``random``: the live experts at random places among E, as the
    dispatch leaves them (dead blocks between live ones);
  * ``first``: the same number live as the first experts, the rest dead:
    the launch order a device-built list of live (expert, column block)
    items gives, live blocks first and the dead ones last, without the
    cost of building the list;
  * ``alone``: the live experts as an E' = live batch with rows=None: no
    dead block at all, what a design that launches only the live work
    (a list or a persistent grid over it) comes to at most with the
    same body.
At E = 64, 2048 -> 1408 and 1408 -> 2048 with 35 live (deepseek-moe-16b)
and E = 256, 7168 -> 2048 and 2048 -> 7168 with 57 live (deepseek-v3),
live weight copies past the 50 MB L2. The three are alternated
``--rounds`` times; each is printed with its median, least and most.
``first``'s live experts are checked torch.equal to ``alone``. Writes the
table to chiprun_out/rows_probe.txt. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as C  # noqa: E402
from repro_torch.kernels import sparqle_matmul as S  # noqa: E402

SHAPES = ((64, 2048, 1408, 35), (64, 1408, 2048, 35),
          (256, 7168, 2048, 57), (256, 2048, 7168, 57))
WAYS = ("random", "first", "alone")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = [C.nvidia_smi_line()]
    for e, k, n, live in SHAPES:
        case = C.batched_case(dev, gen, e, 1, k, n, "alternating")
        ops = [case[x] for x in ("lsb", "msb", "pop", "wp", "asc", "wsc")]
        copies = max(1, math.ceil(150e6 / (live * k * n // 2)))
        sets = [ops] + [ops[:3] + [ops[3].clone()] + ops[4:]
                        for _ in range(copies - 1)]
        pick = torch.randperm(e, generator=gen, device=dev)[:live]
        first = torch.tensor([1] * live + [0] * (e - live),
                             dtype=torch.int32, device=dev)
        scattered = torch.zeros(e, dtype=torch.int32, device=dev)
        scattered[pick] = 1
        alone = [tuple(t[:live].contiguous() for t in s) for s in sets]
        calls = {
            "random": (lambda *a: S.sparqle_matmul(*a, rows=scattered),
                       [tuple(s) for s in sets]),
            "first": (lambda *a: S.sparqle_matmul(*a, rows=first),
                      [tuple(s) for s in sets]),
            "alone": (lambda *a: S.sparqle_matmul(*a), alone)}
        got = S.sparqle_matmul(*sets[0], rows=first)[:live]
        if not torch.equal(got, S.sparqle_matmul(*alone[0])):
            raise AssertionError(f"E={e} {k}->{n}: the first {live} experts "
                                 f"differ from the E'={live} batch")
        times = {w: [] for w in WAYS}
        for _ in range(args.rounds):
            for w in WAYS:
                fn, a = calls[w]
                times[w].append(C.time_ms(fn, a, 50) * 1e3)
        med = {w: statistics.median(t) for w, t in times.items()}
        lines.append(
            f"E={e} C=1 {k}->{n}, {live} live, {copies} weight copies, "
            f"{args.rounds} alternated rounds, us median [least, most]: "
            + "; ".join(f"{w} {med[w]:.2f} [{min(times[w]):.2f}, "
                        f"{max(times[w]):.2f}]" for w in WAYS)
            + f"; first/random {med['first'] / med['random']:.3f}, "
              f"alone/random {med['alone'] / med['random']:.3f}")
        print(lines[-1], flush=True)
        del case, ops, sets, alone, calls
        torch.cuda.empty_cache()
    C.OUT.mkdir(exist_ok=True)
    (C.OUT / "rows_probe.txt").write_text("\n".join(lines) + "\n")
    print(lines[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

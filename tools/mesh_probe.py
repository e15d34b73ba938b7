"""Where the ``--legacy`` steps on a (1, 2) mesh first part from one
device's: granite-8b at full width, ``--layers`` layers, f32, the run of
``chip_smoke.py`` phase 22c (prefill of 64 tokens, 8 greedy decode
steps).

    python tools/mesh_probe.py [--layers 2] [--batch 8] [--seed 0] \
        [--out chiprun_out/mesh_probe.json]

The one-device run records every projection (``models.model.linear``:
its input and output, in call order) on the card; then two ranks share
the card over gloo as the (data, model) = (1, 2) mesh, and each rank
holds each of its projections, in the same order, against the recorded
one: equal bits or not, and the largest difference, of the input and of
the output (a column-cut output against its rank's columns, a row-cut
input against its rank's K slice). Each rank also holds its own
attention over its heads (``layers.flash_attention`` on the heads it
attends) against the same heads attended together with all the others
on the same inputs, and the decode's merged partial attention (row 7p
over each half of the cache, ``kernels.ref.merge_partials``) against
one row-7 call over the whole cache. Prints one JSON object (and writes
it to ``--out``): per rank the first projection that parts, and the
count of those that part in each phase, and the head's (each step's
logits) largest difference over its largest magnitude; the file also
holds that ratio for every call's input and output. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402

WAYS = 2


def _install(hook) -> None:
    """Wrap ``models.model.linear``: ``hook(phase, x, y)`` after every
    call, ``phase`` 'prefill' inside ``models.model.prefill``, else
    'decode'."""
    from repro_torch.models import model as M
    linear_, prefill_, phase = M.linear, M.prefill, ["decode"]

    def linear(x, w, b=None, *, tp=None):
        y = linear_(x, w, b, tp=tp)
        hook(phase[0], x, y)
        return y

    def prefill(*args, **kw):
        phase[0] = "prefill"
        try:
            return prefill_(*args, **kw)
        finally:
            phase[0] = "decode"
    M.linear, M.prefill = linear, prefill


def _diff(mine: torch.Tensor, want: torch.Tensor, rank: int):
    """(equal bits, max abs diff, max abs of want) of ``mine`` against
    ``want`` whole, or against its rank's slice of the last dim."""
    mine, want = mine.float(), want.float()
    if mine.shape != want.shape:
        n = mine.shape[-1]
        if want.shape[-1] != n * WAYS or mine.shape[:-1] != want.shape[:-1]:
            return None
        want = want[..., rank * n:(rank + 1) * n]
    return (bool(torch.equal(mine, want)),
            float((mine - want).abs().max()), float(want.abs().max()))


def _attention_checks(dev, rank: int) -> dict:
    """The rank's heads attended alone against all heads together (the
    prefill's shapes), and the merged halves of a cache against one row-7
    call (the decode's, f32 q): largest differences."""
    from repro_torch.kernels.kv_attention import (
        kv4_decode_attention, kv4_decode_attention_partial)
    from repro_torch.kernels.ref import merge_partials
    from repro_torch.models.layers import AttnSpec, flash_attention
    cfg = C.mesh_legacy_config()
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = 8, C.MESH_LEGACY_PROMPT
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((b, s, h, hd), generator=g, device=dev)
    k = torch.randn((b, s, kvh, hd), generator=g, device=dev)
    v = torch.randn((b, s, kvh, hd), generator=g, device=dev)
    spec = AttnSpec(causal=True, window=0, prefix_len=0)
    whole = flash_attention(q, k, v, spec)
    n, nk = h // WAYS, kvh // WAYS
    mine = flash_attention(q[:, :, rank * n:(rank + 1) * n],
                           k[:, :, rank * nk:(rank + 1) * nk],
                           v[:, :, rank * nk:(rank + 1) * nk], spec)
    heads = whole[:, :, rank * n:(rank + 1) * n]
    smax = C.MESH_LEGACY_MAXLEN
    cache = C.contiguous_cache(dev, g, b, smax, kvh, hd)
    qd = torch.randn((b, kvh, h // kvh, hd), generator=g, device=dev)
    pos = torch.full((b,), C.MESH_LEGACY_PROMPT + 3, dtype=torch.int32,
                     device=dev)
    one = kv4_decode_attention(qd, *cache, pos)
    half = smax // WAYS
    outs, lses = [], []
    for r in range(WAYS):
        part = tuple(t[:, r * half:(r + 1) * half].contiguous()
                     for t in cache)
        o, lse = kv4_decode_attention_partial(qd, *part, pos,
                                              start=r * half)
        outs.append(o)
        lses.append(lse)
    merged = merge_partials(outs, lses)
    return {"heads_alone_vs_together": {
                "equal": bool(torch.equal(mine, heads)),
                "max_abs": float((mine - heads).abs().max())},
            "merged_halves_vs_row7": {
                "equal": bool(torch.equal(merged, one)),
                "max_abs": float((merged - one).abs().max())}}


def _rank(rank: int, seed: int, batch: int, layers: int, single) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.MESH_LEGACY_LAYERS = layers
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []

    def hook(phase, x, y):
        i = len(rows)
        wx, wy = single[i] if i < len(single) else (None, None)
        rows.append({"i": i, "phase": phase,
                     "shape": [list(x.shape), list(y.shape)],
                     "x": None if wx is None else _diff(x, wx, rank),
                     "y": None if wy is None else _diff(y, wy, rank)})

    _install(hook)
    C.mesh_legacy_run(dev, seed, batch, (1, WAYS), rank)
    parted = [r for r in rows if r["y"] is None or not r["y"][0]]

    def rel(d):
        return None if d is None else d[1] / max(d[2], 1e-30)
    vocab = C.mesh_legacy_config().vocab
    return {"rank": rank, "calls": len(rows),
            # every call's largest difference over its largest magnitude
            "rel": [[r["i"], r["phase"], rel(r["x"]), rel(r["y"])]
                    for r in rows],
            # the head's (the logits of each step, the rank's columns)
            "head_rel": [rel(r["y"]) for r in rows
                         if r["shape"][1][-1] * WAYS >= vocab],
            "first_parted": parted[0] if parted else None,
            "first_input_parted": next(
                (r for r in rows if r["x"] is None or not r["x"][0]), None),
            "parted": {p: sum(r["phase"] == p for r in parted)
                       for p in ("prefill", "decode")},
            "first_calls": rows[:12],
            "attention": _attention_checks(dev, rank)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=C.MESH_LEGACY_LAYERS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/mesh_probe.json")
    args = ap.parse_args()
    from repro_torch import kernels
    from repro_torch.launch.mesh import spawn_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.MESH_LEGACY_LAYERS = args.layers
    kernels.build_all()
    dev = torch.device("cuda", 0)
    single = []
    _install(lambda phase, x, y: single.append((x.detach().clone(),
                                                y.detach().clone())))
    C.mesh_legacy_run(dev, args.seed, args.batch)
    ranks = spawn_world(_rank, WAYS, args.seed, args.batch, args.layers,
                        single, backend="gloo", device_type="cuda",
                        timeout_s=C.TP_TIMEOUT_S)
    out = {"card": C.nvidia_smi_line(), "layers": args.layers,
           "batch": args.batch, "one_device_calls": len(single),
           "ranks": ranks}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": out["card"], "ranks": [
        {k: r[k] for k in ("rank", "calls", "parted", "first_parted",
                           "first_input_parted", "head_rel", "attention")}
        for r in ranks]}))


if __name__ == "__main__":
    main()

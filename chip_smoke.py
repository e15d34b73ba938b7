"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # every phase, one GPU
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, each printing one line, phase 5 one more per seed (details go
to chiprun_out/):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (parallel nvcc);
  3. hold each kernel against its plain PyTorch version on the card at
     the serving shapes (encoder and matmul bit-exact, attention within
     ATTN_TOL) and time kernel, plain version and library call;
  4. serve granite-8b at full width and depth through the port's Engine
     (8 requests x 128 prompt tokens x 16 new, 8 decode slots), with the
     launch counters zeroed just before and read just after, then profile
     a shorter run of the same engine shape;
  5. cross-check, for XC_SEEDS seeds: granite width, 2 layers, f32 — the
     same weights and prompts through the Engine on the card (kernels)
     and on the CPU (plain versions), logits within LOGIT_TOL and the
     greedy token streams identical;
  6. the ``kernels`` JSON line, the card line, then the ``ok`` line.
Any failed check raises, so the script exits non-zero without the last
line. It needs a CUDA card and the rest of the repository beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out"

# Stated tolerances. Encoder and matmul are integer work (and the same
# f32 drain multiplies): bit-exact. Attention sums in another order than
# the plain einsum/softmax: |err| <= ATTN_TOL in f32.
ATTN_TOL = 1e-4
# Cross-check: identical integer linears, but f32 attention/rope/matmul
# orders differ between card and CPU, which can move an int8 rounding
# by one step downstream: max |dlogit| <= LOGIT_TOL * max |logit|. The
# limit is about twice the worst reading on seeds 0-2 (0.0203, 0.0184,
# 4e-7 of max |logit| on an H100); the greedy streams must agree.
LOGIT_TOL = 0.04
XC_SEEDS = 3

# Published H100 peaks (NVIDIA data sheets; dense): bytes/s, int8 op/s,
# f32 (non-tensor) flop/s, by the name nvidia-smi reports.
PEAKS = {"PCIe": (2.0e12, 1513e12, 51e12), "NVL": (3.9e12, 1671e12, 60e12),
         "SXM": (3.35e12, 1979e12, 67e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def time_ms(fn, args_list, iters: int = 20) -> float:
    """Mean device ms per call, cycling over ``args_list`` (so that weight
    sets larger than L2 arrive cold, as in a decode step). The calls are
    captured once into a CUDA graph and the replay is timed with CUDA
    events, so host-side wrapper overhead is not counted."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_encoder(dev, gen, peaks):
    from repro_torch.core.quantize import activation_scale
    from repro_torch.kernels.ref import TILE_K, sparqle_encode_ref
    from repro_torch.kernels.sparqle_encode import sparqle_encode
    rows = []
    for m in (1, 4, 8, 32):
        for k in (4096, 14336):
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn((m, k), generator=gen, device=dev)
                     * torch.rand((m, 1), generator=gen, device=dev) * 4
                     ).to(dt)
                if m > 1:
                    x[0] = 0                     # degenerate all-zero row
                scale = activation_scale(x).float()
                blocks = torch.rand((k // TILE_K,), generator=gen,
                                    device=dev) < 0.5
                mask = torch.repeat_interleave(blocks, TILE_K)
                want = sparqle_encode_ref(x, scale, mask, -8, 23)
                for with_pbm in (True, False):
                    got = sparqle_encode(x, scale, mask, -8, 23,
                                         with_pbm=with_pbm)
                    for g, w, name in zip(got, want,
                                          ("lsb", "msb", "pbm", "pop")):
                        if name == "pbm" and not with_pbm:
                            continue
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"encoder {name} differs at M={m} K={k} "
                                f"{dt} with_pbm={with_pbm}")
                rows.append((m, k, dt, x, scale, mask))
    # timed as the serving linear calls it (no PBM plane) at the decode
    # shape of a d_model-wide projection input
    m, k, dt, x, scale, mask = next(r for r in rows if r[0] == 8
                                    and r[1] == 4096
                                    and r[2] == torch.bfloat16)

    def encode(*a):
        return sparqle_encode(*a, with_pbm=False)

    args = [(x, scale, mask, -8, 23)]
    kms = time_ms(encode, args, 200)
    pms = time_ms(sparqle_encode_ref, args, 50)
    pop = encode(*args[0])[3]
    nbytes = m * k * 2 + m * 4 + k + 2 * m * k + pop.numel() * 4
    return {"name": "sparqle_encode", "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": "src/repro/kernels/sparqle_encode.py:69",
            "max_abs_err": 0.0, "ms": kms, "plain_ms": pms,
            "bound_ms": nbytes / peaks[0] * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "shape": f"M={m} K={k} bf16 no PBM plane, checked M in "
                     f"1,4,8,32 x K in 4096,14336 x bf16,f32 x with/"
                     f"without PBM"}


def check_matmul(dev, gen, peaks):
    from repro_torch.core.qlinear import pack_int4
    from repro_torch.kernels.ref import (TILE_K, TILE_M, sparqle_matmul_ref,
                                         tile_population_padded)
    from repro_torch.kernels.sparqle_matmul import sparqle_matmul
    shapes = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
    detail = []
    timed = None
    for k, n in shapes:
        w = torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        wp = pack_int4(w)
        wsc = torch.rand((1, n), generator=gen, device=dev) * 0.01 + 1e-3
        for m in (1, 4, 8, 32):
            q = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            msb, lsb = q >> 4, q & 0xF
            # zero the MSB plane of every other K tile: pop-0 and pop>0
            tiles = torch.arange(k, device=dev) // TILE_K
            msb = torch.where((tiles % 2 == 0)[None, :], msb,
                              torch.zeros_like(msb))
            pop = tile_population_padded(msb != 0, TILE_M, TILE_K)
            asc = torch.rand((m, 1), generator=gen, device=dev) * 0.1
            got = sparqle_matmul(lsb, msb, pop, wp, asc, wsc)
            want = sparqle_matmul_ref(lsb, msb, pop, wp, asc, wsc)
            acc = sparqle_matmul(lsb, msb, pop, wp, asc, wsc, acc_out=True)
            acc_ref = sparqle_matmul_ref(lsb, msb, pop, wp, asc, wsc,
                                         acc_out=True)
            if not (torch.equal(got, want) and torch.equal(acc, acc_ref)):
                raise AssertionError(f"matmul differs at M={m} K={k} N={n}")
            if m == 8:
                copies = max(1, math.ceil(150e6 / wp.numel()))
                wps = [wp.clone() for _ in range(copies)]
                args = [(lsb, msb, pop, c, asc, wsc) for c in wps]
                kms = time_ms(sparqle_matmul, args, 50)
                pms = time_ms(sparqle_matmul_ref, args[:1], 5)
                ml = max(m, 32)    # torch._int_mm needs more than 16 rows
                qa = torch.zeros((ml, k), dtype=torch.int8, device=dev)
                qa[:m] = q
                lib = time_ms(torch._int_mm, [(qa, w)], 50)
                live = (pop > 0).sum().item() / pop.numel()
                nbytes = (m * k * (1 + live) + k * n // 2 + m * 4 + n * 4
                          + m * n * 4)
                ops = 2.0 * m * k * n * (1 + live)
                bound = max(nbytes / peaks[0], ops / peaks[1]) * 1e3
                by = "bytes" if nbytes / peaks[0] >= ops / peaks[1] \
                    else "operations"
                detail.append({"M": m, "K": k, "N": n, "ms": kms,
                               "plain_ms": pms, "library_ms": lib,
                               "bound_ms": bound, "bound_by": by})
                if (k, n) == (4096, 14336):
                    timed = detail[-1]
    return {"name": "sparqle_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_matmul.cu",
            "replaces": "src/repro/kernels/sparqle_matmul.py:209",
            "max_abs_err": 0.0, "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": "M=8 K=4096 N=14336 (w_gate/w_up at decode); "
                     "library: torch._int_mm at M=32", "detail": detail}


def check_attention(dev, gen, peaks):
    from repro_torch.kernels.kv_attention import kv4_paged_decode_attention
    from repro_torch.kernels.ref import kv4_paged_decode_attention_ref
    b, kvh, g, hd, ps, n_s, n_pages = 8, 8, 4, 128, 16, 16, 160
    kp = torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                       generator=gen, device=dev, dtype=torch.int8)
    vp = torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                       generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((n_pages, ps, kvh), generator=gen, device=dev) * 0.2
    vs = torch.rand((n_pages, ps, kvh), generator=gen, device=dev) * 0.2
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    pos = torch.tensor([0, 15, 16, 17, 100, 143, 255, 0], dtype=torch.int32,
                       device=dev)
    tables[-1] = 0                 # inactive slot: null page, pos 0
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
        args = (q, kp, ks, vp, vs, tables, pos)
        got = kv4_paged_decode_attention(*args).float()
        want = kv4_paged_decode_attention_ref(*args).float()
        e = (got - want).abs().max().item()
        tol = ATTN_TOL if dt == torch.float32 else 2 ** -7 * max(
            1.0, want.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"attention {dt}: max err {e} > {tol}")
        if dt == torch.float32:
            err, f32_args = e, args
    kms = time_ms(kv4_paged_decode_attention, [f32_args], 200)
    pms = time_ms(kv4_paged_decode_attention_ref, [f32_args], 20)
    toks = sum((min(int(p) // ps, n_s - 1) + 1) * ps for p in pos.tolist())
    nbytes = (b * kvh * g * hd * 4 * 2 + toks * kvh * (hd // 2 + 4) * 2
              + b * n_s * 4 + b * 4)
    flops = 4.0 * toks * kvh * g * hd
    bound = max(nbytes / peaks[0], flops / peaks[2]) * 1e3
    return {"name": "kv4_paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:206",
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / peaks[0] >= flops / peaks[2]
            else "operations", "library_ms": None,
            "shape": "B=8 KVH=8 G=4 hd=128 ps=16 Pmax=16, f32 q"}


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------

def serve_granite(dev, seed: int):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_served_params, make_engine,
                                          make_prompts, run_requests)
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    params = build_served_params(cfg, seed, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    batch, plen, gen = 8, 128, 16
    eng = make_engine(cfg, params, batch=batch, prompt_len=plen, gen=gen,
                      page_size=16, token_budget=128, prefill_chunk=32,
                      decode_slots=8, device=dev)
    prompts = make_prompts(cfg, seed, batch, plen)
    kernels.reset_launch_counts()
    r = run_requests(eng, prompts, gen)
    counts = kernels.launch_counts()
    r.update(layers=cfg.n_layers, d_model=cfg.d_model, build_s=t_build,
             launches=counts,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if r["finished"] != batch or any(len(s) != gen for s in r["streams"]):
        raise AssertionError(f"unfinished requests: {r['streams']}")
    if any(not 0 <= t < cfg.vocab for s in r["streams"] for t in s):
        raise AssertionError("token outside the vocabulary")
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel was never launched: {counts}")
    r["profile"] = profile_engine(cfg, params, dev, seed)
    del eng, params
    torch.cuda.empty_cache()
    return r


def profile_engine(cfg, params, dev, seed: int):
    """Where the time goes: a shorter workload on the same engine shape
    (8 requests x 32 prompt tokens x 8 new) under torch.profiler (device
    time by kernel, device busy share of the wall), then under cProfile
    (host time by function), written to chiprun_out/. Launches here come
    after the counters were read."""
    import cProfile
    import io
    import pstats
    from repro_torch.launch.serve import (make_engine, make_prompts,
                                          run_requests)
    from torch.profiler import ProfilerActivity, profile
    prompts = make_prompts(cfg, seed + 7, 8, 32)

    def workload():
        eng = make_engine(cfg, params, batch=8, prompt_len=32, gen=8,
                          device=dev)
        return run_requests(eng, prompts, 8)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = workload()
    ka = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ka)
    (OUT / "profile_device.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=40))
    (OUT / "profile_host.txt").write_text(ka.table(
        sort_by="self_cpu_time_total", row_limit=40))
    pr = cProfile.Profile()
    pr.enable()
    r2 = workload()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(40)
    (OUT / "profile_python.txt").write_text(buf.getvalue())
    return {"profiled_wall_s": r["wall_s"], "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / r["wall_s"],
            "cprofiled_wall_s": r2["wall_s"]}


def cross_check(dev, seed: int):
    """Granite width, 2 layers, f32: Engine on the card vs on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, make_engine,
                                          make_prompts)
    from repro_torch.serving import SamplingParams
    cfg = get_config("granite-8b").replace(n_layers=2, dtype="float32")
    params = build_served_params(cfg, seed, "cpu")
    prompts = make_prompts(cfg, seed + 1, 2, 32)
    gen = 4
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        eng = make_engine(cfg, tree_to(params, device), batch=2,
                          prompt_len=32, gen=gen, device=device)
        logits = []

        def record(fn):
            def wrapped(*a):
                out = fn(*a)
                logits.append(out[0].float().cpu())
                return out
            return wrapped
        eng._prefill_fn = record(eng._prefill_fn)
        eng._decode_fn = record(eng._decode_fn)
        hs = [eng.submit(p, SamplingParams(max_new_tokens=gen))
              for p in prompts]
        eng.run()
        runs[name] = (logits, [list(h.out_tokens) for h in hs])
    (lg_c, st_c), (lg_p, st_p) = runs["cuda"], runs["cpu"]
    match = sum(a == b for x, y in zip(st_c, st_p) for a, b in zip(x, y))
    total = sum(len(x) for x in st_p)
    # logits compare step by step while both runs fed the same tokens
    n_cmp = len(lg_p) if st_c == st_p else 2
    err = max((a - b).abs().max().item()
              for a, b in zip(lg_c[:n_cmp], lg_p[:n_cmp]))
    scale = max(b.abs().max().item() for b in lg_p[:n_cmp])
    log(f"    seed {seed}: max |dlogit| {err:.4g} of max |logit| "
        f"{scale:.4g} ({err / scale:.4g} rel) over {n_cmp} steps, greedy "
        f"tokens {match}/{total}")
    if not err <= LOGIT_TOL * scale:
        raise AssertionError(f"cross-check logits differ: {err} vs "
                             f"{LOGIT_TOL} * {scale}")
    if st_c != st_p:
        raise AssertionError(f"cross-check greedy streams differ: cuda "
                             f"{st_c} vs cpu {st_p}")
    return {"seed": seed, "max_abs_logit_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "steps_compared": n_cmp,
            "greedy_match": f"{match}/{total}"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    OUT.mkdir(exist_ok=True)

    card = nvidia_smi_line()
    log(f"[1] card: {card}")
    peaks = peaks_for(card.split(",")[0])

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"[2] built {len(kernels.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    (OUT / "kernel_build.log").write_text("\n".join(
        f"== {k.name}\n{k.build_log}" for k in kernels.KERNELS.values()))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [check_encoder(dev, gen, peaks), check_matmul(dev, gen, peaks),
            check_attention(dev, gen, peaks)]
    for r in rows:
        log(f"[3] {r['name']}: ok (err {r['max_abs_err']:.3g}), "
            f"{r['ms'] * 1e3:.1f} us vs plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) at "
            f"{r['shape']}")
    detail = {"card": card, "kernels": rows}
    if not args.kernels_only:
        eng = serve_granite(dev, args.seed)
        log(f"[4] granite-8b {eng['layers']}L d={eng['d_model']}: "
            f"{eng['requests']} requests, {eng['tokens']} tokens, "
            f"{eng['tokens_per_s']:.1f} tok/s, TTFT mean "
            f"{eng['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{eng['tpot_mean_s'] * 1e3:.2f} ms, {eng['steps']} steps, "
            f"launches {eng['launches']}, weights built in "
            f"{eng['build_s']:.1f} s, peak {eng['peak_mem_gb']:.1f} GB; "
            f"profiled rerun: device busy {eng['profile']['device_busy_s']:.3f}"
            f" s of {eng['profile']['profiled_wall_s']:.2f} s wall")
        t0 = time.perf_counter()
        xc = [cross_check(dev, args.seed + i) for i in range(XC_SEEDS)]
        worst = max(xc, key=lambda r: r["rel_err"])
        log(f"[5] cross-check granite width 2L f32 cuda vs cpu, "
            f"{XC_SEEDS} seeds: worst max |dlogit| "
            f"{worst['max_abs_logit_err']:.3g} of max |logit| "
            f"{worst['max_abs_logit']:.3g} ({worst['rel_err']:.3g} rel, "
            f"tol {LOGIT_TOL} rel), greedy tokens "
            f"{', '.join(r['greedy_match'] for r in xc)}, "
            f"{time.perf_counter() - t0:.1f} s")
        detail.update(engine={k: v for k, v in eng.items()
                              if k not in ("aggregate",)}, cross_check=xc)
        for r in rows:
            key = {"sparqle_encode": "sparqle_encode",
                   "sparqle_matmul": "sparqle_matmul",
                   "kv4_paged_decode_attention": "kv_attention"}[r["name"]]
            r["launches"] = eng["launches"][key]
    else:
        for r in rows:
            r["launches"] = 0
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1,
                                                    default=str))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("kernels: " + json.dumps([{k: r[k] for k in keys} for r in rows]))
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

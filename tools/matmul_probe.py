"""Where the dual-pass matmul's time goes, on one card.

    python tools/matmul_probe.py [--variants base,noload,nocompute]

Builds copies of ``src/repro_torch/csrc/sparqle_matmul.cu`` with one part
of the mainloop cut out and times each, full and draft instance, at the
decode shapes (M = 8) with ``chip_smoke.time_ms``:
  * ``base``: the kernel as it is;
  * ``noload``: no stage is refilled by TMA after the prologue (each
    stage still gets its arrival), so the warps compute on stale tiles:
    the compute and pipeline skeleton alone;
  * ``nocompute``: the k32 steps are skipped (the stream alone).
Beside them: the launch floor (one tiny PyTorch kernel) and a plain
streaming read of the same cold weight bytes (16 B loads, grid-stride,
4 in flight a thread), the practical rate of this card for one kernel.
The cut copies compute wrong results; the port never calls them.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sparqle_matmul as S  # noqa: E402

CUTS = {"base": [],
        # the stage's arrival stays, so no mbarrier phase is left waiting
        "noload": [("      if (tma && tid == 0)\n        tma_part(",
                    "      if (tma && tid == 0) mbar_arrive(&bar[st]);\n"
                    "      if (false)\n        tma_part(")],
        "nocompute": [("for (int ss = 0; ss < 2; ++ss) {",
                       "for (int ss = 0; ss < 0; ++ss) {")]}
STREAM = r"""
__global__ void stream_read_kernel(const uint4* __restrict__ p, long n,
                                   unsigned* out) {
  unsigned x = 0;
  const long stride = (long)gridDim.x * blockDim.x;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const uint4 a = __ldcs(p + i), b = __ldcs(p + i + stride),
                c = __ldcs(p + i + 2 * stride), d = __ldcs(p + i + 3 * stride);
    x ^= a.x ^ a.w ^ b.x ^ b.w ^ c.x ^ c.w ^ d.x ^ d.w;
  }
  for (; i < n; i += stride) x ^= p[i].x;
  if (x == 0x12345678u) out[0] = x;
}
extern "C" int stream_read_launch(const void* p, long nbytes, void* out,
                                  void* stream) {
  stream_read_kernel<<<264, 512, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, nbytes / 16, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""
SHAPES = [(8, 4096, 14336), (8, 4096, 4096), (8, 4096, 1024),
          (8, 14336, 4096)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base,noload,nocompute")
    args = ap.parse_args()
    src = (_build.CSRC / "sparqle_matmul.cu").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for v in args.variants.split(","):
        text = src
        for old, new in CUTS[v]:
            if old not in text:
                sys.exit(f"{v}: the mainloop no longer has {old!r}")
            text = text.replace(old, new)
        path = out_dir / f"sparqle_matmul_{v}.cu"
        path.write_text(text + STREAM)
        kernels[v] = (_build.Kernel(str(path), "sparqle_matmul_launch",
                                    S._ENTRY, name=f"full_{v}"),
                      _build.Kernel(str(path), "sparqle_matmul_draft_launch",
                                    S._DRAFT, name=f"draft_{v}"))
    builds = [(k[0], k[0].start_build()) for k in kernels.values()]
    for k, proc in builds:
        k.finish_build(proc)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    peaks = C.peaks_for(card.split(",")[0])
    C.MATMUL_TIMED = SHAPES
    for v, (full, draft) in kernels.items():
        S.KERNEL, S.DRAFT_KERNEL = full, draft
        gen = torch.Generator(device=dev).manual_seed(0)
        d = C.time_matmul_family(dev, gen, peaks,
                                 ["sparqle_matmul", "sparqle_matmul_draft"])
        for name, rows in d.items():
            print(f"{v} {name}: " + ", ".join(
                f"{r['K']}->{r['N']} {r['ms'] * 1e3:.2f} us" for r in rows),
                flush=True)
    one = torch.zeros(1, device=dev)
    print(f"launch floor: "
          f"{C.time_ms(lambda x: x.add_(1), [(one,)], 50) * 1e3:.2f} us")
    first = next(iter(kernels.values()))[0]
    stream = _build.Kernel(str(first.source), "stream_read_launch",
                           [_build.P, ctypes.c_long, _build.P, _build.P],
                           name="stream_read")
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for _, k, n in SHAPES[:1]:
        nb = k * n // 2
        bufs = [torch.randint(-8, 8, (nb,), device=dev, dtype=torch.int8)
                for _ in range(-(-150_000_000 // nb))]
        ms = C.time_ms(lambda w: stream.launch(w.data_ptr(), nb,
                                               sink.data_ptr()),
                       [(w,) for w in bufs], 50)
        print(f"streaming read of {nb} cold bytes: {ms * 1e3:.2f} us "
              f"({nb / ms / 1e9:.2f} TB/s)")
    print(card)


if __name__ == "__main__":
    main()

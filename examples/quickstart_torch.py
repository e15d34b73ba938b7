"""Quickstart on the PyTorch/CUDA port: the SPARQLe idea end to end
(twin of ``examples/quickstart.py``, on ``repro_torch``).

1. Decompose an int8 activation tensor into LSB4 / MSB4 / PBM (paper §3.1)
2. Enhance MSB4 sparsity with column-importance clipping (paper §3.2)
3. Run the dual-pass matmul — bit-exact vs the dense int8 baseline (§3.3);
   on a card these are the port's CUDA kernels (``sparqle_matmul`` and
   ``quant_matmul``), on the CPU their plain versions
4. Predict the accelerator-level latency/energy win at that sparsity (§4)

Run:  PYTHONPATH=src python examples/quickstart_torch.py            (card)
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      (--m 2048 --k 4096 --n 11008 runs the cost model's own shape)
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core.clipping import (apply_clipping,
                                       importance_mask_tile_aligned)
from repro_torch.core.costmodel import HardwareConfig, LinearShape, linear_cost
from repro_torch.core.qlinear import pack_int4
from repro_torch.core.quantize import quantize_activations, quantize_weights
from repro_torch.core.sparqle import (compression_percent, encode,
                                      ops_reduction_percent,
                                      subprecision_sparsity)
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.ref import tile_population_padded
from repro_torch.kernels.sparqle_matmul import sparqle_matmul
from repro_torch.serving.engine import resolve_device

# the linear the accelerator model prices (paper §4)
COST_SHAPE = (2048, 4096, 11008)


def make_inputs(m: int, k: int, n: int, seed: int = 0):
    """A "realistic" activation matrix — near-zero Laplace bulk with
    every 17th column an outlier channel x25 — and a Gaussian weight, as
    numpy f32 arrays ((m, k), (k, n))."""
    rng = np.random.default_rng(seed)
    x = (rng.laplace(size=(m, k)) * 4.0).astype(np.float32)
    x[:, ::17] *= 25.0
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    x_np, w_np = make_inputs(args.m, args.k, args.n, args.seed)
    x, w = torch.from_numpy(x_np).to(dev), torch.from_numpy(w_np).to(dev)

    qa = quantize_activations(x, bits=8, per_token=True)
    qw = quantize_weights(w, bits=4, axis=0)

    s0 = float(subprecision_sparsity(qa.q))
    comp = float(compression_percent(s0))
    ops = float(ops_reduction_percent(s0))
    print(f"natural MSB4 sparsity            : {s0*100:5.1f}%")
    print(f"  -> Eq.1 compression            : {comp:5.1f}% bytes saved")
    print(f"  -> Eq.2 ops reduction          : {ops:5.1f}% int4 MACs skipped")

    # --- §3.2: clip the 50% least-important columns (tile-aligned) -----
    # aggressive bounds fully clear the masked columns — maximum sparsity
    # end of the accuracy/efficiency knob
    mask = importance_mask_tile_aligned(w, 50.0, tile_k=128)
    q_clip = apply_clipping(qa.q, mask, l=-128, h=127)
    s1 = float(subprecision_sparsity(q_clip))
    print(f"after clipping (k=50, full range): {s1*100:5.1f}%")

    # --- §3.3: dual-pass kernel == dense baseline, bit-exact -----------
    act = encode(q_clip)
    pop = tile_population_padded(act.pbm)     # the kernel's skip tiles
    asc = qa.scale.reshape(-1, 1)
    wsc = qw.scale.reshape(1, -1)
    w_packed = pack_int4(qw.q.to(torch.int8))
    out_sparqle = sparqle_matmul(act.lsb4, act.msb4, pop, w_packed, asc, wsc)
    out_dense = quant_matmul(q_clip, w_packed, asc, wsc)
    exact = bool(torch.equal(out_sparqle, out_dense))
    if not exact:
        raise AssertionError("dual pass differs from the dense int8 matmul")
    skipped = float((pop == 0).float().mean())
    print(f"dual-pass == dense int8 matmul   : bit-exact on {dev.type} "
          f"({skipped*100:.0f}% of MSB4 tiles skipped)")

    # --- §4: what the hybrid accelerator buys at this sparsity ---------
    hw = HardwareConfig()
    shape = LinearShape("demo", *COST_SHAPE, w_bits=4, s=s1)
    base = linear_cost(shape, hw, sparqle=False)
    spq = linear_cost(shape, hw, sparqle=True)
    lat = (1 - spq.cycles / base.cycles) * 100
    energy = (1 - spq.energy_pj / base.energy_pj) * 100
    print(f"accelerator model @ s={s1:.2f}      : latency -{lat:.1f}%, "
          f"energy -{energy:.1f}%")
    return {"s0": s0, "compression": comp, "ops_reduction": ops, "s1": s1,
            "exact": exact, "skipped": skipped,
            "cycles": (base.cycles, spq.cycles),
            "energy_pj": (base.energy_pj, spq.energy_pj),
            "latency_saved": lat, "energy_saved": energy,
            "out": out_sparqle}


if __name__ == "__main__":
    main(sys.argv[1:])

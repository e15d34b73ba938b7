"""Calibrate clipping constants, quantize into SPARQLe form, and serve on
the PyTorch/CUDA port (twin of ``examples/calibrate_and_serve.py``).

The full deployment recipe of the paper:
  1. train (or load) a float model                       — substrate
  2. GLOBAL calibration: sweep (l, h) on calibration data (§3.2, Llama
     recipe) against the sparsity/error tradeoff
  3. LAYERWISE calibration: Algorithm 1 — learn per-layer (l, h) with
     everything frozen (BitNet recipe)
  4. quantize W4A8 + clipping masks -> SparqleLinear served form
  5. serve: prefill + decode on the sub-precision path (the decode as a
     compiled step, a CUDA graph on a card, as ``launch/serve.py``'s
     fixed-batch loop runs it)

Run:  PYTHONPATH=src python examples/calibrate_and_serve_torch.py  (card)
      PYTHONPATH=src python examples/calibrate_and_serve_torch.py \\
          --device cpu                  (granite-8b smoke config, ~10 s)
      ... --full --layers 2             (granite-8b's full width, 2 layers)
"""
import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.clipping import (apply_clipping, global_calibrate,
                                       importance_mask_tile_aligned,
                                       init_clip_params,
                                       learn_clipping_constants,
                                       soft_clipping)
from repro_torch.core.qlinear import quantize_model_params
from repro_torch.core.quantize import quantize_activations
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.launch.graphs import CompiledStep
from repro_torch.models import model as M
from repro_torch.models.schema import init_params
from repro_torch.models.schema_builder import build_schema
from repro_torch.serving.engine import resolve_device

CAL_BATCH, CAL_SEQ = 4, 64
EPOCHS = 23
B, P, GEN = 2, 32, 8


def calibration_data(cfg, params, device):
    """(q8, mask): the int8 hidden stream of one calibration batch
    (SyntheticLM step 0, 4 x 64 tokens) through the float model, and the
    tile-aligned importance mask of layer 0's ``w_gate`` (k = 50%)."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=CAL_SEQ,
                                  global_batch=CAL_BATCH))
    cal = torch.from_numpy(data.batch_at(0)["tokens"]).to(device)
    with torch.no_grad():
        hidden = M.forward_hidden(cfg, params, {"tokens": cal})
    q8 = quantize_activations(hidden.reshape(-1, hidden.shape[-1]),
                              bits=8, per_token=True).q
    w0 = params["stages"]["s0"]["p0"]["w_gate"][0]
    return q8, importance_mask_tile_aligned(w0, 50.0, 16)


def sweep(q8, mask):
    """Step 2: the global (l, h) sweep. Returns the chosen SweepResult
    and every candidate's (l, h, mse, sparsity)."""
    seen = []

    def eval_fn(l, h):
        qc = apply_clipping(q8, mask, l, h)
        mse = float(torch.mean((qc - q8).float() ** 2))
        sp = float(subprecision_sparsity(qc))
        seen.append((l, h, mse, sp))
        return mse, sp

    return global_calibrate(eval_fn), seen


def algorithm1(q8, mask, l0: float, h0: float):
    """Step 3: Algorithm 1 from the sweep's (l, h), weights frozen.
    Returns ((l, h) learned, loss history)."""
    maskf = mask.float()

    def apply_clip(cp, batch):
        y, m = soft_clipping(batch, maskf, cp["l"][0], cp["h"][0], tau=4.0)
        return y * 0.01, torch.mean(m)

    def apply_base(batch):
        return batch.float() * 0.01

    cp, hist = learn_clipping_constants(
        apply_clip, apply_base, q8.reshape(CAL_BATCH, -1, q8.shape[-1]),
        init_clip_params(1, l0=l0, h0=h0, device=q8.device),
        epochs=EPOCHS, lr=1.0, alpha=0.5)
    return (float(cp["l"][0]), float(cp["h"][0])), hist


def serve(cfg, qparams, device, gen: int = GEN):
    """Steps 4-5's serve: B prompts of P tokens (SyntheticLM step 7),
    whole-prompt prefill, then ``gen - 1`` greedy decode steps through a
    compiled step. Returns the (B, gen) tokens as lists."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=CAL_SEQ,
                                  global_batch=CAL_BATCH))
    prompts = torch.from_numpy(data.batch_at(7)["tokens"][:B, :P]).to(device)
    prefill = S.make_serve_prefill(cfg, P + gen)
    decode = CompiledStep(S.make_serve_decode(cfg), device)
    tok, cache = prefill(qparams, {"tokens": prompts})
    outs = [tok]
    for i in range(gen - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
        tok, cache = decode(qparams, cache, tok, pos)
        outs.append(tok)
    return torch.stack(outs, 1).tolist()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its smoke config)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: as is)")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="compute dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("granite-8b", smoke=not args.full)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    params = init_params(build_schema(cfg), args.seed, dev)

    # ---- step 2: global (l, h) sweep on a calibration batch -----------
    q8, mask = calibration_data(cfg, params, dev)
    best, candidates = sweep(q8, mask)
    print(f"global calibration  : l={best.l} h={best.h} "
          f"sparsity={best.sparsity*100:.1f}% err={best.error:.3f}")

    # ---- step 3: Algorithm 1 — layerwise learned constants ------------
    (l1, h1), hist = algorithm1(q8, mask, float(best.l), float(best.h))
    print(f"Algorithm 1 ({EPOCHS} it) : l={l1:.1f} h={h1:.1f} "
          f"(learned, weights frozen)")

    # ---- steps 4-5: quantize + serve ----------------------------------
    qparams = quantize_model_params(params, w_bits=cfg.w_bits,
                                    k_percent=50.0, clip_l=l1, clip_h=h1,
                                    tile_k=16)
    tokens = serve(cfg, qparams, dev)
    print(f"served              : ({B}, {GEN}) tokens on the SPARQLe W4A8 "
          f"path ({dev.type})")
    print(f"generated tokens[0] : {tokens[0]}")
    return {"cfg": cfg, "params": params, "q8": q8, "mask": mask,
            "best": best, "candidates": candidates, "clip": (l1, h1),
            "history": hist, "qparams": qparams, "tokens": tokens}


if __name__ == "__main__":
    main(sys.argv[1:])

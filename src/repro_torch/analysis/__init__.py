"""Static invariant checking for the port's serving stack (torch twin of
``repro.analysis``).

Two layers, with the reference's rule IDs restated for torch:

* **AST rules** (``astlint.py``) over ``src/repro_torch``: host effects
  must not be reachable from the step closures that the port captures
  as CUDA graphs (a ``print``, a timer or an obs call runs once at
  capture and never at replay), host-only modules must not launch
  device ops, host syncs (``.item()``, ``.cpu()``, data-dependent
  shapes) must not sit in step-reachable code, and metric names must
  follow the registry's discipline.
* **Traced-step contracts** (``stepcheck.py``): the *real* step closures
  of ``launch/steps.py`` (prefill chunk, decode, the LSB4-only draft,
  the verify window) traced with ``make_fx`` on tiny configs on the CPU,
  single-device and on 1x2 and 2x2 meshes, and their graphs walked: the
  collective inventory, one int32 SUM all-reduce a row-parallel linear
  paired with an f32 MAX, the int32 accumulator's dtype discipline, the
  draft's MSB-plane elision, and no host sync inside a serving step.

CLI: ``python -m repro_torch.analysis --check``. Intentionally kept
findings live in ``allowlist.txt`` beside this file, each with a reason.
This package imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import hashlib
import json

VERSION = "1.0.0"

# Rule catalog: ID -> one-line contract statement. The ruleset hash is
# derived from this mapping (plus VERSION), so adding or changing a rule
# changes the hash.
RULES = {
    "SPL001": "no host side effects (print/time/logging/obs registry/"
              "tracer) in functions reachable from the step closures "
              "captured as CUDA graphs: they run at capture, not at "
              "replay",
    "SPL002": "no torch device ops (torch.<op>, .to(), .cuda()) in "
              "host-only modules (serving/scheduler.py, "
              "serving/kv_pool.py, obs/)",
    "SPL003": "no host syncs (.item()/.tolist()/.cpu()/.numpy(), float()/"
              "int()/bool() or Python control flow on a tensor, "
              "data-dependent shapes: nonzero/masked_select/unique) in "
              "step-reachable code",
    "SPL004": "metric names registered via MetricsRegistry must be "
              "well-formed and cataloged in docs/observability.md",
    "TXP001": "serving step graphs contain no collectives outside the "
              "committed allowlist",
    "TXP002": "over the model group a SUM all-reduce is int32 only and "
              "paired 1:1 with an f32 MAX all-reduce; the transformer "
              "decode holds exactly two a layer (wo, w_down)",
    "TXP003": "the int32 accumulator of the plane matmuls meets no float "
              "op before its one rescale",
    "TXP004": "the msb_skip draft holds exactly half the int-plane "
              "matmuls of the full decode and none fed by the "
              "activation's MSB plane",
    "TXP005": "no _local_scalar_dense, no copy to the CPU and no op with "
              "a data-dependent output shape inside any serving step",
}


def ruleset_hash() -> str:
    """Stable 16-hex digest of the active rule set + analyzer version."""
    blob = json.dumps({"version": VERSION, "rules": RULES}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]

"""Parameter schema: declare params once, derive init (torch twin of
``repro.models.schema``).

Leaves are drawn from the same distribution as the JAX package's
``_init_leaf`` — ``normal * 1/sqrt(fan_in)`` with fan-in the product of
all but the last dim (layer axis included), zeros/ones, or ``normal *
scale`` for the embedding — from one explicit ``torch.Generator`` in
sorted-path order. The numbers differ from ``jax.random`` for the same
seed; the parity tests therefore convert JAX params instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.qlinear import is_quantizable, quantize_leaf, stack_linears


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"              # normal | zeros | ones | embed
    scale: Optional[float] = None     # overrides fan-in scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError((self.shape, self.axes))


Schema = Dict[str, object]  # nested dict of ParamSpec


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) <= 1:
        return max(1, shape[0] if shape else 1)
    return math.prod(shape[:-1])


def _std(spec: ParamSpec) -> float:
    if spec.init == "embed":
        return spec.scale if spec.scale is not None else 1.0
    if spec.scale is not None:
        return spec.scale
    return 1.0 / math.sqrt(_fan_in(spec.shape))


def _init_leaf(gen: torch.Generator, spec: ParamSpec, device,
               shape=None) -> torch.Tensor:
    shape = spec.shape if shape is None else shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * _std(spec)).to(spec.dtype)


def _map_schema(schema: Schema, fn: Callable[[str, ParamSpec], object],
                prefix: str = "") -> Dict:
    out = {}
    for k, v in schema.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = fn(path, v) if isinstance(v, ParamSpec) else _map_schema(
            v, fn, path)
    return out


def _sorted_paths(schema: Schema):
    paths = []
    _map_schema(schema, lambda p, s: paths.append(p))
    return sorted(paths)


def init_params(schema: Schema, seed: int, device="cpu") -> Dict:
    """Materialize a float param tree from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = {}
    flat = {}
    _map_schema(schema, lambda p, s: flat.__setitem__(p, s))
    for path in _sorted_paths(schema):
        leaves[path] = _init_leaf(gen, flat[path], device)
    return _map_schema(schema, lambda p, s: leaves[p])


def init_quantized_params(schema: Schema, seed: int, device, *,
                          float_dtype: Optional[torch.dtype] = None,
                          **quant_kw) -> Dict:
    """Materialize the SPARQLe served tree directly: every projection is
    drawn and quantized one layer at a time, so no float copy of the
    whole model ever exists (granite-8b's would be 32 GB in f32). Other
    leaves are drawn whole; ``float_dtype`` casts the embedding table to
    the compute dtype — the model casts it to that dtype at every use
    (lookup and tied head) anyway, so the values are unchanged."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    _map_schema(schema, lambda p, s: flat.__setitem__(p, s))
    leaves = {}
    for path in _sorted_paths(schema):
        spec = flat[path]
        if is_quantizable(path, torch.empty(spec.shape, device="meta")):
            if len(spec.shape) == 2:
                leaves[path] = quantize_leaf(
                    _init_leaf(gen, spec, device), **quant_kw)
            else:
                leaves[path] = stack_linears([
                    quantize_leaf(_init_leaf(gen, spec, device,
                                             shape=spec.shape[1:]),
                                  **quant_kw)
                    for _ in range(spec.shape[0])])
        else:
            x = _init_leaf(gen, spec, device)
            if float_dtype is not None and spec.init == "embed":
                x = x.to(float_dtype)
            leaves[path] = x
    return _map_schema(schema, lambda p, s: leaves[p])

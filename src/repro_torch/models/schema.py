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

from repro_torch.core.qlinear import (concat_experts, is_expert,
                                      is_quantizable, quantize_leaf,
                                      stack_linears)

# A routed-expert leaf is drawn and quantized a chunk of experts at a
# time, each chunk's f32 draw at most this many bytes: one chunk, the
# whole layer, for every arch but deepseek-v3-671b, whose (256, 7168,
# 2048) layer is 15.0 GB in f32 (deepseek-moe-16b's is 0.74 GB).
EXPERT_DRAW_BYTES = 1 << 30


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


def abstract_params(schema: Schema) -> Dict:
    """The param tree's layout as meta tensors (shapes and dtypes, no
    storage): the ``like`` tree of ``checkpoint.store.restore``."""
    return _map_schema(schema, lambda _, s: torch.empty(
        s.shape, dtype=s.dtype, device="meta"))


def init_params(schema: Schema, seed: int, device="cpu") -> Dict:
    """Materialize a float param tree from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = {}
    flat = {}
    _map_schema(schema, lambda p, s: flat.__setitem__(p, s))
    for path in _sorted_paths(schema):
        leaves[path] = _init_leaf(gen, flat[path], device)
    return _map_schema(schema, lambda p, s: leaves[p])


def _quantized_draw(gen: torch.Generator, spec: ParamSpec, device,
                    shape, expert: bool, quant_kw) -> object:
    """One layer's projection (``shape``) drawn and quantized; a
    routed-expert layer a chunk of at most EXPERT_DRAW_BYTES of experts
    at a time, the chunks joined (quantization is per expert, so the join
    is the whole leaf's quantization of the same draw)."""
    if not expert:
        return quantize_leaf(_init_leaf(gen, spec, device, shape=shape),
                             **quant_kw)
    per = max(1, EXPERT_DRAW_BYTES // (math.prod(shape[1:]) * 4))
    return concat_experts([
        quantize_leaf(_init_leaf(gen, spec, device,
                                 shape=(min(per, shape[0] - e0),)
                                 + tuple(shape[1:])), **quant_kw)
        for e0 in range(0, shape[0], per)])


def init_quantized_params(schema: Schema, seed: int, device, *,
                          float_dtype: Optional[torch.dtype] = None,
                          **quant_kw) -> Dict:
    """Materialize the SPARQLe served tree directly: every projection is
    drawn and quantized one layer at a time, so no float copy of the
    whole model ever exists (granite-8b's would be 32 GB in f32; a
    routed-expert leaf is drawn (E, K, N) a layer: deepseek-moe-16b's
    0.74 GB where the stacked leaf would be 19.9 GB). Other
    leaves are drawn whole; ``float_dtype`` casts the embedding table to
    the compute dtype — the model casts it to that dtype at every use
    (lookup and tied head) anyway, so the values are unchanged. A
    routed-expert layer is drawn at most EXPERT_DRAW_BYTES of experts at
    a time (deepseek-v3-671b's layer would be 15.0 GB in f32 drawn
    whole)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    _map_schema(schema, lambda p, s: flat.__setitem__(p, s))
    leaves = {}
    for path in _sorted_paths(schema):
        spec = flat[path]
        if is_quantizable(path, torch.empty(spec.shape, device="meta")):
            expert = is_expert(path)
            if len(spec.shape) == 2 or (len(spec.shape) == 3 and expert):
                leaves[path] = _quantized_draw(gen, spec, device, spec.shape,
                                               expert, quant_kw)
            else:
                leaves[path] = stack_linears([
                    _quantized_draw(gen, spec, device, spec.shape[1:],
                                    expert, quant_kw)
                    for _ in range(spec.shape[0])])
        else:
            x = _init_leaf(gen, spec, device)
            if float_dtype is not None and spec.init == "embed":
                x = x.to(float_dtype)
            leaves[path] = x
    return _map_schema(schema, lambda p, s: leaves[p])

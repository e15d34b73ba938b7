"""Architecture registry (torch twin of ``repro.models.registry``):
``--arch <id>`` -> config, schemas, abstract inputs and caches, and the
cell plan.

The cell plan (which of the four assigned shapes each arch runs, and
why the others are skipped) is the reference's: 32 runnable cells of
40. Abstract inputs and caches are meta tensors (shapes and dtypes, no
storage), as ``models/schema.py`` ``abstract_params`` gives the params;
a cache is declared as a ParamSpec tree, so its placement on a mesh
follows from its logical axes (``distributed/sharding.py`` ``spec_for``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCHS as _ARCHS
from repro_torch.configs import SMOKES, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.schema import ParamSpec, Schema
from repro_torch.models.schema_builder import build_schema
from repro_torch.models.stages import build_stages

# the reference's order of archs (its cell list is in this order)
_ORDER = ("starcoder2-3b", "granite-8b", "gemma3-27b", "yi-6b",
          "hubert-xlarge", "jamba-v0.1-52b", "deepseek-v3-671b",
          "deepseek-moe-16b", "paligemma-3b", "mamba2-2.7b")
ARCHS: Dict[str, ModelConfig] = {n: _ARCHS[n] for n in _ORDER}

__all__ = ["ARCHS", "SMOKES", "cache_schema", "cell_plan", "describe",
           "get_config", "input_specs", "model_schema", "param_count",
           "runnable_cells"]


# ---------------------------------------------------------------------------
# the cell plan
# ---------------------------------------------------------------------------

def cell_plan(name: str) -> List[Tuple[str, bool, str]]:
    """[(shape, runs, reason)] for all four assigned shapes."""
    cfg = get_config(name)
    sub_quadratic = cfg.family in ("ssm", "hybrid") or bool(cfg.global_every)
    plan = []
    for sname, shp in SHAPES.items():
        if cfg.family == "encoder" and shp.kind == "decode":
            plan.append((sname, False, "encoder-only: no autoregressive step"))
        elif sname == "long_500k" and not sub_quadratic:
            plan.append((sname, False, "pure full attention: 500k decode "
                                       "requires sub-quadratic attention"))
        else:
            plan.append((sname, True, ""))
    return plan


def runnable_cells() -> List[Tuple[str, str]]:
    return [(name, sname) for name in ARCHS
            for sname, runs, _ in cell_plan(name) if runs]


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                kind: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Abstract model inputs (meta tensors) of one shape cell. ``kind``
    defaults to the shape's: 'train' gives tokens (frames, patches +
    tokens) and targets, 'prefill' the same without targets, 'decode'
    {token, pos}."""
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.cdtype
    if kind == "decode":
        return {"token": _meta((b,), torch.int32),
                "pos": _meta((b,), torch.int32)}
    spec: Dict[str, torch.Tensor] = {}
    if cfg.family == "encoder":
        spec["frames"] = _meta((b, s, cfg.d_model), dt)
    elif cfg.family == "vlm":
        spec["patches"] = _meta((b, cfg.n_prefix, cfg.d_model), dt)
        spec["tokens"] = _meta((b, s - cfg.n_prefix), torch.int32)
    else:
        spec["tokens"] = _meta((b, s), torch.int32)
    if kind == "train":
        tgt_s = s - cfg.n_prefix if cfg.family == "vlm" else s
        spec["targets"] = _meta((b, tgt_s), torch.int32)
    return spec


# ---------------------------------------------------------------------------
# the cache tree as a schema
# ---------------------------------------------------------------------------

def cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> Schema:
    """ParamSpec tree of the contiguous caches ``models.model.prefill``
    returns: a GQA layer's packed K/V and scales, an MLA layer's packed
    compressed KV, its scales and rope keys, an SSD layer's state and
    conv tail, each layer-stacked."""
    b, smax = batch, max_len
    pack = 2 if cfg.kv_bits == 4 else 1

    def layer_cache(ld) -> Schema:
        if ld.mixer == "attn":
            kvh, hd = cfg.n_kv_heads, cfg.hd
            kv = ("batch", "kv_seq", "kv_heads")
            return {
                "k_q": ParamSpec((b, smax, kvh, hd // pack), kv + (None,),
                                 torch.int8, init="zeros"),
                "k_s": ParamSpec((b, smax, kvh), kv, torch.float32,
                                 init="ones"),
                "v_q": ParamSpec((b, smax, kvh, hd // pack), kv + (None,),
                                 torch.int8, init="zeros"),
                "v_s": ParamSpec((b, smax, kvh), kv, torch.float32,
                                 init="ones"),
            }
        if ld.mixer == "mla":
            return {
                "ckv_q": ParamSpec((b, smax, cfg.kv_lora_rank // pack),
                                   ("batch", "kv_seq", None), torch.int8,
                                   init="zeros"),
                "ckv_s": ParamSpec((b, smax), ("batch", "kv_seq"),
                                   torch.float32, init="ones"),
                "kr": ParamSpec((b, smax, cfg.qk_rope_dim),
                                ("batch", "kv_seq", None), cfg.cdtype,
                                init="zeros"),
            }
        din = cfg.d_inner
        g, n, p_ = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
        nh = din // p_
        return {
            "h": ParamSpec((b, g, nh // g, p_, n),
                           ("batch", None, "heads", None, None),
                           torch.float32, init="zeros"),
            "conv": ParamSpec((b, cfg.conv_width - 1, din + 2 * g * n),
                              ("batch", None, "mlp"), cfg.cdtype,
                              init="zeros"),
        }

    def stack(tree: Schema, repeat: int) -> Schema:
        return {k: ParamSpec((repeat,) + v.shape, ("layers",) + v.axes,
                             v.dtype, v.init, v.scale)
                for k, v in tree.items()}

    return {"stages": {
        f"s{si}": {f"p{pi}": stack(layer_cache(ld), stage.repeat)
                   for pi, ld in enumerate(stage.period)}
        for si, stage in enumerate(build_stages(cfg))}}


def model_schema(cfg: ModelConfig) -> Schema:
    return build_schema(cfg)


def param_count(schema) -> int:
    """Elements of every ParamSpec leaf of a schema tree."""
    if isinstance(schema, ParamSpec):
        n = 1
        for d in schema.shape:
            n *= d
        return n
    return sum(param_count(v) for v in schema.values())


def describe(name: str) -> Dict[str, Any]:
    cfg = get_config(name)
    n = param_count(build_schema(cfg))
    return {
        "name": name, "family": cfg.family, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "params_b": round(n / 1e9, 2),
        "cells": cell_plan(name),
    }

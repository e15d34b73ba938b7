"""Layer-stacking plan: stages of repeated periods (copy of
``repro.models.stages``): dense transformers, MoE, the SSD hybrid
(jamba: one period of ``attn_every`` layers, attention in the middle)
and the pure SSD stack (mamba2)."""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str                  # "attn" | "mla" | "ssd"
    ffn: str                    # "dense" | "moe" | "none"
    window: int = 0             # 0 = full attention
    rope_theta: float = 0.0     # 0 -> cfg.rope_theta


@dataclasses.dataclass(frozen=True)
class Stage:
    period: List[LayerDef]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.repeat


def build_stages(cfg: ModelConfig) -> List[Stage]:
    if cfg.family == "moe":
        return _moe_stages(cfg)
    if cfg.family == "hybrid":
        return _hybrid_stages(cfg)
    if cfg.family == "ssm":
        return [Stage([LayerDef("ssd", "none")], cfg.n_layers)]
    if cfg.family not in ("transformer", "encoder", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if cfg.global_every:  # gemma3: (global_every-1) local then 1 global
        ge = cfg.global_every
        period = [LayerDef("attn", "dense", window=cfg.sliding_window)
                  for _ in range(ge - 1)]
        period += [LayerDef("attn", "dense", window=0, rope_theta=1e6)]
        n_full, tail = divmod(cfg.n_layers, ge)
        stages = [Stage(period, n_full)]
        if tail:
            stages.append(Stage(
                [LayerDef("attn", "dense", window=cfg.sliding_window)
                 for _ in range(tail)], 1))
        return stages
    return [Stage([LayerDef("attn", "dense", window=cfg.sliding_window)],
                  cfg.n_layers)]


def _moe_stages(cfg: ModelConfig) -> List[Stage]:
    """``first_dense`` dense layers, then the MoE layers: every layer
    (``moe_every`` 1) or periods of ``moe_every`` with the MoE FFN last.
    A depth cut to the dense layers alone (``n_layers == first_dense``)
    has no MoE stage (one of no layers would hold empty leaves)."""
    mixer = "mla" if cfg.use_mla else "attn"
    stages = []
    if cfg.first_dense:
        stages.append(Stage([LayerDef(mixer, "dense")], cfg.first_dense))
    n_moe = cfg.n_layers - cfg.first_dense
    if n_moe <= 0 < cfg.first_dense:
        return stages
    if cfg.moe_every > 1:
        period = [LayerDef(mixer, "moe" if i == cfg.moe_every - 1
                           else "dense") for i in range(cfg.moe_every)]
        stages.append(Stage(period, n_moe // cfg.moe_every))
    else:
        stages.append(Stage([LayerDef(mixer, "moe")], n_moe))
    return stages


def _hybrid_stages(cfg: ModelConfig) -> List[Stage]:
    """jamba: one period of ``attn_every`` layers repeated, attention at
    the period's middle and SSD elsewhere, the MoE FFN where
    ``i % moe_every == moe_every - 1`` (dense elsewhere)."""
    ae = cfg.attn_every or 8
    period = []
    for i in range(ae):
        mixer = "attn" if i == ae // 2 else "ssd"
        ffn = "moe" if (cfg.n_experts and i % cfg.moe_every ==
                        cfg.moe_every - 1) else "dense"
        period.append(LayerDef(mixer, ffn))
    assert cfg.n_layers % ae == 0, (cfg.n_layers, ae)
    return [Stage(period, cfg.n_layers // ae)]

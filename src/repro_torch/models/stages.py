"""Layer-stacking plan: stages of repeated periods (copy of
``repro.models.stages``, the families the port serves)."""
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

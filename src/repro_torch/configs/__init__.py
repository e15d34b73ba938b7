"""Model configurations the port serves or trains (``--arch <id>`` ->
config)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_moe_16b, deepseek_v3_671b,
                                 gemma3_27b, granite_8b, hubert_xlarge,
                                 jamba_v01_52b, mamba2_2p7b, paligemma_3b,
                                 starcoder2_3b, yi_6b)
from repro_torch.configs.base import ModelConfig

_MODULES = [granite_8b, yi_6b, starcoder2_3b, deepseek_moe_16b, gemma3_27b,
            paligemma_3b, deepseek_v3_671b, mamba2_2p7b, jamba_v01_52b,
            hubert_xlarge]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "ModelConfig", "SMOKES", "get_config"]

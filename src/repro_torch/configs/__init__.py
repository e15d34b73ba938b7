"""Model configurations the port serves (``--arch <id>`` -> config)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import granite_8b
from repro_torch.configs.base import ModelConfig

_MODULES = [granite_8b]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "ModelConfig", "SMOKES", "get_config"]

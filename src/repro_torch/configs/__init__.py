"""Architecture registry of the port: the configs it runs, by name."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, check_supported, pad_vocab, smoke

__all__ = ["ModelConfig", "check_supported", "get_config", "list_archs", "pad_vocab", "smoke"]

_ARCH_MODULES: Dict[str, str] = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port runs {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG

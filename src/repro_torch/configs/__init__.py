"""Architecture registry: one module per assigned architecture."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, SHAPES, shape_supported

_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "chameleon-34b": "chameleon_34b",
    "zamba2-7b": "zamba2_7b",
    "smollm-360m": "smollm_360m",
    "starcoder2-15b": "starcoder2_15b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2.5-32b": "qwen2_5_32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get(a) for a in ARCH_IDS}

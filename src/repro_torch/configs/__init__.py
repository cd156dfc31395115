"""Architecture registry: one module per assigned architecture (port of
``repro/configs``; data only, all ten copied, the families the port does
not run yet among them)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeConfig, param_count

ARCH_IDS = [
    "whisper_tiny",
    "deepseek_v2_lite_16b",
    "deepseek_v3_671b",
    "zamba2_2p7b",
    "llava_next_34b",
    "minitron_8b",
    "llama3_405b",
    "deepseek_7b",
    "phi4_mini_3p8b",
    "rwkv6_3b",
]

# cli aliases with dashes/dots
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def get_reduced_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced_config", "all_configs", "param_count"]

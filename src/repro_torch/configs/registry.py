"""Architecture registry: maps --arch ids to config modules."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "hubert-xlarge",
    "zamba2-1.2b",
    "mamba2-1.3b",
    "phi3-mini-3.8b",
    "granite-3-2b",
    "deepseek-coder-33b",
    "qwen1.5-0.5b",
    "deepseek-moe-16b",
    "llama4-maverick-400b-a17b",
    "internvl2-2b",
    # the paper's own model family (used by the PTQ benchmarks/examples)
    "llama3-1b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG.validate()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

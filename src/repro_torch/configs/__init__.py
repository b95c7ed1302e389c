"""Architecture registry of the port: one module per arch, `CONFIG` in each.

Usage: repro_torch.configs.get("stablelm-3b") -> ArchConfig.

`ARCHS` names only the architectures the port can run; the others are added
by the slices that port their blocks.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARCHS: tuple[str, ...] = (
    "arctic-480b",
    "gemma3-4b",
    "internvl2-26b",
    "minicpm3-4b",
    "qwen3-moe-235b-a22b",
    "recurrentgemma-9b",
    "rwkv6-3b",
    "stablelm-3b",
    "whisper-base",
)

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get"]

"""Architecture registry of the port: one module per arch, `CONFIG` in each.

Usage: repro_torch.configs.get("stablelm-3b") -> ArchConfig;
       repro_torch.configs.ARCHS lists all ten assigned ids, as the
       reference's registry does, and `cells()` / `runnable()` are its.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARCHS: tuple[str, ...] = (
    "recurrentgemma-9b",
    "internvl2-26b",
    "minicpm3-4b",
    "command-r-plus-104b",
    "gemma3-4b",
    "stablelm-3b",
    "whisper-base",
    "arctic-480b",
    "qwen3-moe-235b-a22b",
    "rwkv6-3b",
)

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells() -> list[tuple[str, str]]:
    """All 40 assigned (arch, shape) cells; skips are resolved by runnable()."""
    return [(a, s) for a in ARCHS for s in SHAPES]


def runnable(arch: str, shape: str) -> tuple[bool, str]:
    """(should_run, reason).  long_500k only for sub-quadratic archs."""
    cfg = get(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md S4)"
    return True, ""


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get", "cells",
           "runnable"]

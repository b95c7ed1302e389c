"""Model zoo of the port: decoder-only stacks of attention (attn / local),
RG-LRU and RWKV-6 blocks."""
from .config import SHAPES, ArchConfig, MLAConfig, MoEConfig, ShapeConfig
from .model import (Model, ModelOutput, decode_step, forward, init_caches,
                    init_params, prefill, segments)

__all__ = [
    "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig", "Model", "ModelOutput",
    "ShapeConfig", "decode_step", "forward", "init_caches", "init_params",
    "prefill", "segments",
]

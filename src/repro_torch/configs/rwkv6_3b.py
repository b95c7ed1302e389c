"""rwkv6-3b — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536,
head_dim 64 (40 heads).  Time-mix (wkv6 kernel) + channel-mix blocks;
O(1) state => runs long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    pattern=("rwkv6",),
    rwkv_head_dim=64,
)

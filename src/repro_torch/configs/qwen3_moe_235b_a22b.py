"""qwen3-moe-235b-a22b — deep MoE: 94L, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  d_model=4096 64H (GQA kv=4, head_dim=128)
expert d_ff=1536, vocab=151936.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    ffn="moe",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  group_size=1024),
)

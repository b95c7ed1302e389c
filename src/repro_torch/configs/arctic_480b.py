"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864, 128e top-2, dense residual d_ff=4864, vocab=32000.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    ffn="moe",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864, group_size=1024),
)

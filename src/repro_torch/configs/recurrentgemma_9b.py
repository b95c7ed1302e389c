"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2 attn:rnn.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, local window 2048, recurrence width = d_model, tied embeddings.
Pattern period (rglru, rglru, local) covers 38 = 12*3 + 2 layers.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru_width=4096,
    tied_embeddings=True,
)

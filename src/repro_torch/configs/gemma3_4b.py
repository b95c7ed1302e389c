"""gemma3-4b — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, sliding window 1024, tied embeddings.
Pattern period: 5 local + 1 global covers 34 = 5*6 + 4 layers.
Counts as sub-quadratic for long_500k: decode-time global layers are O(S)
per token and the stack is dominated by the 1024-token window (DESIGN.md S4).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    tied_embeddings=True,
)

"""command-r-plus-104b — large dense GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01; unverified]  64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000, rope theta 75e6.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e6,
)

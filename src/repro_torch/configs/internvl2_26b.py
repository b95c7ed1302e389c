"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]  Backbone only: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553.  The vision tower is a stub: input_specs() provides
precomputed patch embeddings (B, frontend_seq, d_model), projected and
prepended to the text embeddings (DESIGN.md S4).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="patch_stub",
    frontend_seq=1024,
)

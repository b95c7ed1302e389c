"""whisper-base — encoder-decoder; conv audio frontend is a STUB.

[arXiv:2212.04356; unverified]  6L enc + 6L dec, d_model=512 8H (kv=8)
d_ff=2048 vocab=51865, GELU FFN.  input_specs() provides precomputed
mel-conv frame embeddings (B, 1500, d_model); decoder cross-attends with
cached K/V after prefill.  Decode shapes exercise the decoder; RoPE is used
for decoder self-attention in place of learned positions (DESIGN.md S8).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    ffn="gelu",
    enc_dec=True,
    num_encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
)

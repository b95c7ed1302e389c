"""Architecture configuration schema for the model zoo (PyTorch port).

A copy of the JAX package's schema with the same fields and defaults, so a
config converts between the two with `dataclasses.asdict`.  The port keeps its
own copy because the machines that run it have no JAX installed.

Two runtime knobs are kept only for that field parity and are ignored here:
`use_pallas` and `unroll_layers`.  The JAX model runs its jnp attention unless
`use_pallas` is set (default False); the port instead picks the hand-written
kernel or its plain version from the *device* of the tensors: a CUDA tensor
launches the kernel, a CPU tensor takes the plain version.  `remat` and
`remat_policy` ("full", "dots", "none") are read by the training forward
(`models/model.py`).

Every assigned architecture is expressed as an `ArchConfig`; layer stacking is
described by a repeating `pattern` of block kinds so heterogeneous stacks
(gemma3's 5 local : 1 global, recurrentgemma's 2 RG-LRU : 1 local-attn) group
into the same segments as in the JAX package (see models/model.py).

Block kinds:
  "attn"   : global attention (GQA + RoPE)
  "local"  : sliding-window attention (window = cfg.window)
  "mla"    : multi-head latent attention (DeepSeek/MiniCPM3 style)
  "rglru"  : Griffin RG-LRU recurrent block
  "rwkv6"  : RWKV-6 time-mix block (paired with RWKV channel-mix FFN)

FFN kinds (per block, fixed per arch): "swiglu", "gelu" (whisper), "moe".
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual_d_ff: int = 0   # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    group_size: int = 1024          # tokens per dispatch group (memory knob)
    vectorize_groups: bool = False  # vmap groups (parallel, data-sharded)
    # instead of lax.map (sequential — one group per step starves all but one
    # data shard and forces giant all-gathers; see EXPERIMENTS.md #Perf)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[str, ...] = ("attn",)      # cycled over layers
    ffn: str = "swiglu"
    head_dim: int | None = None               # default d_model // num_heads
    window: int = 1024                        # sliding-window size for "local"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    rope_theta: float = 10000.0
    tied_embeddings: bool = False
    # encoder-decoder (whisper): encoder layers use bidirectional attention
    enc_dec: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500                    # whisper 30s @ 50 Hz after conv
    # modality frontend stub: precomputed embeddings prepended to the text
    frontend: Literal["none", "patch_stub", "audio_stub"] = "none"
    frontend_seq: int = 0                      # patches per sample (vlm)
    # state sizes for recurrent blocks
    rglru_width: int | None = None             # default d_model
    conv_kernel: int = 4
    rwkv_head_dim: int = 64
    # runtime knobs
    dtype: str = "bfloat16"
    use_pallas: bool = False                   # kernels (interpret on CPU)
    remat: bool = True
    remat_policy: str = "full"                 # full | dots | none
    unroll_layers: bool = False                # Python loop instead of scan
    # (dry-run cost calibration: XLA cost analysis counts scan bodies once,
    # so per-layer costs are measured on small unrolled variants)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0

    # --- derived -------------------------------------------------------------

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally over the full sequence, or the
        arch is recurrent — the `long_500k` eligibility rule (DESIGN.md S4).
        gemma3 counts: 5:1 local:global is dominated by the local window and
        decode-time global attention is O(S) per token."""
        kinds = set(self.layer_kinds)
        if kinds <= {"rglru", "rwkv6", "local"}:
            return True
        if self.name.startswith("gemma3"):
            return True
        return False

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tied_embeddings else 2)
        hd = self.head_dim
        for kind in self.layer_kinds:
            if kind in ("attn", "local"):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            elif kind == "mla":
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_head
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += self.num_heads * m.v_head_dim * d
            elif kind == "rglru":
                w = self.rglru_width or d
                total += 2 * d * w + w * self.conv_kernel + 2 * w + w * d  # proj+conv+gates+out
            elif kind == "rwkv6":
                total += 4 * d * d + d * self.rwkv_head_dim  # r,k,v,o (+decay lora approx)
            # FFN
            if self.ffn == "moe":
                assert self.moe is not None
                total += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                total += d * self.moe.num_experts  # router
                if self.moe.dense_residual_d_ff:
                    total += 3 * d * self.moe.dense_residual_d_ff
            elif self.ffn == "swiglu":
                total += 3 * d * self.d_ff
            else:  # gelu
                total += 2 * d * self.d_ff
        if self.enc_dec:
            # encoder blocks + cross attention (rough)
            total += self.num_encoder_layers * (4 * d * d + 2 * d * self.d_ff)
            total += self.num_layers * 4 * d * d  # cross-attn per decoder layer
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.ffn != "moe":
            return self.param_count()
        assert self.moe is not None
        full = self.param_count()
        per_ff = 3 * self.d_model * self.moe.d_ff_expert
        expert_all = self.num_layers * self.moe.num_experts * per_ff
        expert_active = self.num_layers * self.moe.top_k * per_ff
        return full - expert_all + expert_active

    def scaled_down(self, max_layers: int = 4, max_d: int = 128,
                    max_vocab: int = 512, max_experts: int = 8) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        d = min(self.d_model, max_d)
        heads = max(1, min(self.num_heads, d // 32))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        layers = min(self.num_layers, max_layers)
        # keep the pattern period intact when possible so heterogeneity is
        # exercised (e.g. gemma3 local:global, griffin 2:1)
        if len(self.pattern) > 1:
            layers = max(layers, min(self.num_layers, len(self.pattern)))
        moe = None
        if self.moe is not None:
            moe = MoEConfig(
                num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, max_d * 2),
                dense_residual_d_ff=min(self.moe.dense_residual_d_ff, max_d * 2)
                if self.moe.dense_residual_d_ff else 0,
                group_size=64,
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=max_d // 2, kv_lora_rank=max_d // 4,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)
        return dataclasses.replace(
            self,
            num_layers=layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=None if self.mla is None else self.head_dim,
            d_ff=min(self.d_ff, 2 * d),
            vocab_size=min(self.vocab_size, max_vocab),
            window=min(self.window, 32),
            moe=moe,
            mla=mla,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 24),
            frontend_seq=min(self.frontend_seq, 16),
            rglru_width=min(self.rglru_width, d) if self.rglru_width else None,
            rwkv_head_dim=min(self.rwkv_head_dim, 16),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

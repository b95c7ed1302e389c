"""Model assembly of the port: the decoder stack, prefill, decode and the loss.

The JAX package scans each *segment* (whole pattern periods plus a remainder,
see `segments`) over parameters stacked on a leading reps axis.  The port
keeps one `Block` per layer in layer order, `for rep in range(reps): for
kind in period`, and runs them in a Python loop; caches are one dict per
layer.  `segments` stays, since it defines that order (and `interop` reads
JAX parameters with it).

Parameters are trainable `nn.Parameter`s; inference callers run under
`torch.inference_mode()` so that no autograd graph is built.  In training
(`mode="train"` with grad enabled) each block runs under
`torch.utils.checkpoint` when `cfg.remat` and `cfg.remat_policy == "full"`,
as the JAX package wraps its scan body in `jax.checkpoint`.

Block kinds ported so far: "attn" and "local" with a SwiGLU or MoE FFN,
"rglru" (recurrentgemma) with a SwiGLU FFN, and "rwkv6" with its RWKV
channel mix.  The others raise `NotImplementedError` naming the ROADMAP item
that ports them.  Each block returns an auxiliary loss (nonzero only for a
MoE FFN), summed over the blocks into `ModelOutput.aux_loss`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import attention, layers, moe, recurrent
from .config import ArchConfig

_NOT_PORTED = {
    "mla": "ROADMAP A5 (other attention variants: MLA)",
    "gelu": "ROADMAP A5 (other attention variants: whisper)",
    "enc_dec": "ROADMAP A5 (other attention variants: whisper encoder-decoder)",
    "frontend": "ROADMAP A5 (other attention variants: patch/audio frontends)",
}


_KINDS = ("attn", "local", "rglru", "rwkv6")


def _not_ported(what: str):
    return NotImplementedError(f"{what!r} is not ported to PyTorch yet: "
                               f"{_NOT_PORTED[what]}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for any part of `cfg` the port lacks."""
    for kind in cfg.pattern:
        if kind not in _KINDS:
            raise _not_ported(kind)
    if cfg.ffn not in ("swiglu", "moe"):
        raise _not_ported(cfg.ffn)
    if cfg.enc_dec:
        raise _not_ported("enc_dec")
    if cfg.frontend != "none":
        raise _not_ported("frontend")


# --- layer segmentation ----------------------------------------------------------


def segments(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(period kinds, repetitions)] covering cfg.num_layers."""
    p = len(cfg.pattern)
    full, rem = divmod(cfg.num_layers, p)
    out = []
    if full:
        out.append((tuple(cfg.pattern), full))
    if rem:
        out.append((tuple(cfg.pattern[:rem]), 1))
    return out


# --- parameters -------------------------------------------------------------------


def _trainable(params: dict) -> nn.ParameterDict:
    """A ParameterDict of `params`; a nested dict (Arctic's ffn["dense"])
    becomes a nested ParameterDict under the same key."""
    return nn.ParameterDict({k: _trainable(t) if isinstance(t, dict) else nn.Parameter(t)
                             for k, t in params.items()})


class Block(nn.Module):
    """One layer: norm1, mix (attention), norm2, ffn — each a ParameterDict.

    Indexing by name (`block["mix"]`, `block["ffn"]["dense"]`) mirrors the
    JAX parameter dicts."""

    def __init__(self, kind: str, params: dict):
        super().__init__()
        self.kind = kind
        for name, sub in params.items():
            self.add_module(name, _trainable(sub))

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return getattr(self, name)


class Model(nn.Module):
    """Parameters of a decoder-only model, with its blocks in layer order."""

    def __init__(self, cfg: ArchConfig, embed: dict, unembed: dict | None,
                 final_norm: dict, blocks: list[dict]):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
        self.cfg = cfg
        self.embed = _trainable(embed)
        self.unembed = None if unembed is None else _trainable(unembed)
        self.final_norm = _trainable(final_norm)
        self.blocks = nn.ModuleList(
            Block(kind, p) for kind, p in zip(cfg.layer_kinds, blocks, strict=True))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def init_block(cfg: ArchConfig, generator, kind: str, dtype) -> dict:
    if kind not in _KINDS:
        raise _not_ported(kind)
    dev = generator.device
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind == "rglru":
        p["mix"] = recurrent.init_rglru(cfg, generator, dtype)
    elif kind == "rwkv6":
        p["mix"] = recurrent.init_rwkv6(cfg, generator, dtype)
    else:
        p["mix"] = attention.init_attention(cfg, generator, dtype)
    p["norm2"] = layers.init_rmsnorm(cfg.d_model, dtype, dev)
    if kind == "rwkv6":
        p["ffn"] = recurrent.init_rwkv_cmix(cfg, generator, dtype)
    elif cfg.ffn == "moe":
        p["ffn"] = moe.init_moe(cfg, generator, dtype)
    else:
        p["ffn"] = layers.init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Model:
    """Random parameters with the JAX initialisers' scales, drawn from
    `generator`, which must live on `device` (default: `cuda`)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    embed = layers.init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype)
    unembed = (None if cfg.tied_embeddings else
               layers.init_unembed(generator, cfg.d_model, cfg.vocab_size, dtype))
    final_norm = layers.init_rmsnorm(cfg.d_model, dtype, generator.device)
    blocks = [init_block(cfg, generator, kind, dtype) for kind in cfg.layer_kinds]
    return Model(cfg, embed, unembed, final_norm, blocks)


# --- caches -------------------------------------------------------------------------


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                     dtype, device) -> dict:
    if kind == "rglru":
        return {"mix": recurrent.init_rglru_state(cfg, batch, dtype, device)}
    if kind == "rwkv6":
        return {"mix": recurrent.init_rwkv6_state(cfg, batch, dtype, device),
                "cmix": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
    if kind not in _KINDS:
        raise _not_ported(kind)
    return {"mix": attention.init_attn_cache(cfg, batch, max_seq, kind, dtype,
                                             device)}


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                device: str | torch.device | None = None) -> list[dict]:
    """One cache per layer, in layer order."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    return [init_block_cache(cfg, kind, batch, max_seq, dtype, dev)
            for kind in cfg.layer_kinds]


# --- stack apply --------------------------------------------------------------------


def apply_block(cfg: ArchConfig, p: Block, kind: str, x, positions, *, cache=None):
    """Returns (x, cache, aux); the cache is updated in place: attention
    caches by the attention block, recurrent states here.  aux is the MoE
    FFN's auxiliary loss (a float32 tensor), 0.0 for the other FFNs."""
    aux = 0.0
    h = layers.rmsnorm(p["norm1"], x)
    mix_cache = None if cache is None else cache["mix"]
    if kind == "rglru":
        y, new_mix = recurrent.rglru_block(cfg, p["mix"], h, state=mix_cache)
    elif kind == "rwkv6":
        y, new_mix = recurrent.rwkv6_block(cfg, p["mix"], h, state=mix_cache)
    else:
        y, new_mix = attention.attention_block(cfg, p["mix"], h, positions, kind=kind,
                                               cache=mix_cache)
    x = x + y
    h = layers.rmsnorm(p["norm2"], x)
    if kind == "rwkv6":
        y, new_cmix = recurrent.rwkv_cmix(cfg, p["ffn"], h,
                                          state=None if cache is None else cache["cmix"])
    elif cfg.ffn == "moe":
        y, aux = moe.moe_ffn(cfg, p["ffn"], h)
    else:
        y = layers.swiglu(p["ffn"], h)
    if cache is not None:
        cache["mix"] = new_mix
        if kind == "rwkv6":
            cache["cmix"] = new_cmix
    return x + y, cache, aux


# --- public entry points ----------------------------------------------------------------


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor
    caches: list[dict] | None
    aux_loss: torch.Tensor


def forward(cfg: ArchConfig, params: Model, batch: dict, *, caches=None,
            mode: str = "train") -> ModelOutput:
    """batch: tokens (B, S) on the model's device.  Logits are float32."""
    tok = batch["tokens"].long()
    x = layers.embed(params.embed, tok) * (cfg.d_model ** 0.5)
    x = x.to(getattr(torch, cfg.dtype))
    b, s = tok.shape
    if caches is not None and mode == "decode":
        # single-token step: positions come from the cache pointer
        positions = torch.full((b, s), _cache_pos(caches), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    remat = (mode == "train" and cfg.remat and cfg.remat_policy != "none"
             and torch.is_grad_enabled())
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported to PyTorch yet: "
            f"ROADMAP A13 (selective remat policies); use 'full' or 'none'")
    total_aux = 0.0
    for i, block in enumerate(params.blocks):
        cache = None if caches is None else caches[i]
        if remat:
            x, _, aux = checkpoint(apply_block, cfg, block, block.kind, x, positions,
                                   cache=cache, use_reentrant=False)
        else:
            x, _, aux = apply_block(cfg, block, block.kind, x, positions, cache=cache)
        total_aux = total_aux + aux
    x = layers.rmsnorm(params.final_norm, x)
    head = params.embed if cfg.tied_embeddings else params.unembed
    return ModelOutput(logits=layers.unembed(head, x), caches=caches,
                       aux_loss=torch.as_tensor(total_aux, dtype=torch.float32,
                                                device=x.device))


def _cache_pos(caches) -> int:
    """Current decode position from the first attention cache found (all
    attention caches advance together).

    Pure-recurrent stacks (rwkv6) have no positional cache, and no use for
    positions (token shift only), so 0 is returned."""
    for c in caches:
        if "pos" in c["mix"]:
            return c["mix"]["pos"]
    return 0


def prefill(cfg: ArchConfig, params: Model, batch: dict, max_seq: int):
    """Run the prompt, build caches.  Returns (last-token logits, caches)."""
    b = batch["tokens"].shape[0]
    caches = init_caches(cfg, b, max_seq, params.device)
    out = forward(cfg, params, batch, caches=caches, mode="prefill")
    return out.logits[:, -1, :], out.caches


def decode_step(cfg: ArchConfig, params: Model, token, caches):
    """token: (B, 1) int.  Returns (logits (B, vocab), caches), the caches
    advanced in place."""
    out = forward(cfg, params, {"tokens": token}, caches=caches, mode="decode")
    return out.logits[:, -1, :], out.caches



def loss_fn(cfg: ArchConfig, params: Model, batch: dict, aux_weight: float = 0.01):
    """Mean next-token NLL over the label positions with `labels >= 0`, plus
    `aux_weight` times the auxiliary loss (0 for a dense model).  Returns
    (loss, {"nll", "aux"}), as `repro.models.model.loss_fn`."""
    out = forward(cfg, params, batch, mode="train")
    labels = batch["labels"].long()
    logits = out.logits[:, -labels.shape[1]:, :].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = torch.sum((logz - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)
    loss = nll + aux_weight * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}

"""Model assembly of the port: the decoder stack (and whisper's encoder),
prefill, decode and the loss.

The JAX package scans each *segment* (whole pattern periods plus a remainder,
see `segments`) over parameters stacked on a leading reps axis.  The port
keeps one `Block` per layer in layer order, `for rep in range(reps): for
kind in period`, and runs them in a Python loop; caches are one dict per
layer.  `segments` stays, since it defines that order (and `interop` reads
JAX parameters with it).

Parameters are trainable `nn.Parameter`s; inference callers run under
`torch.inference_mode()` so that no autograd graph is built.  In training
(`mode="train"` with grad enabled) each block runs under
`torch.utils.checkpoint` when `cfg.remat`, as the JAX package wraps its scan
body in `jax.checkpoint`: `remat_policy` "full" recomputes the whole block in
the backward, "dots" (JAX's `dots_with_no_batch_dims_saveable`) saves the
output of every matrix product without batch dimensions and recomputes the
rest (`dots_policy`), and "none" runs no checkpoint.

Block kinds: "attn" and "local", "mla" (MiniCPM3), "rglru" (recurrentgemma)
and "rwkv6" (with its RWKV channel mix); FFNs: SwiGLU, GELU (whisper) and MoE.
Each block returns an auxiliary loss (nonzero only for a MoE FFN), summed over
the blocks into `ModelOutput.aux_loss`.

Whisper (`enc_dec`): the encoder is `num_encoder_layers` bidirectional "attn"
blocks over precomputed frame embeddings plus sinusoidal positions (RoPE
too, as every "attn" block applies it), ending in the decoder's
`final_norm`; each decoder block adds cross attention to the encoder output.
Prefill encodes the frames once and writes each decoder layer's cross K/V
into its cache during that forward (the reference encodes them a second time
in `_fill_cross_kv`; the values are the same).  The `patch_stub` frontend
(internvl2) projects precomputed patch embeddings and prepends them to the
token embeddings.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from . import attention, layers, moe, recurrent, sharding
from . import tensor_parallel as tp
from .config import ArchConfig

_KINDS = ("attn", "local", "mla", "rglru", "rwkv6")
_FFNS = ("swiglu", "gelu", "moe")
_FRONTENDS = ("none", "patch_stub", "audio_stub")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ValueError for a block kind, FFN or frontend that the reference
    does not define either."""
    for kind in cfg.pattern:
        if kind not in _KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.ffn not in _FFNS:
        raise ValueError(f"unknown ffn {cfg.ffn!r}")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


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
    JAX parameter dicts; on a sharded model it gathers the group's
    parameters (`sharding.gathered`), so the gather runs where the block
    reads them, inside its remat."""

    def __init__(self, kind: str, params: dict):
        super().__init__()
        self.kind = kind
        for name, sub in params.items():
            self.add_module(name, _trainable(sub))

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return sharding.gathered(getattr(self, name))

    def __contains__(self, name: str) -> bool:
        return name in self._modules


class Model(nn.Module):
    """Parameters of a model: its decoder blocks in layer order, whisper's
    encoder blocks (`encoder`, empty otherwise) and internvl2's `patch_proj`
    (None otherwise)."""

    def __init__(self, cfg: ArchConfig, embed: dict, unembed: dict | None,
                 final_norm: dict, blocks: list[dict], encoder: list[dict] = (),
                 patch_proj: dict | None = None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
        n_enc = cfg.num_encoder_layers if cfg.enc_dec else 0
        if len(encoder) != n_enc:
            raise ValueError(f"{len(encoder)} encoder blocks for {n_enc} encoder layers")
        if (patch_proj is None) != (cfg.frontend != "patch_stub"):
            raise ValueError(f"patch_proj given: {patch_proj is not None}, frontend "
                             f"{cfg.frontend!r}")
        self.cfg = cfg
        self.embed = _trainable(embed)
        self.unembed = None if unembed is None else _trainable(unembed)
        self.final_norm = _trainable(final_norm)
        self.blocks = nn.ModuleList(
            Block(kind, p) for kind, p in zip(cfg.layer_kinds, blocks, strict=True))
        self.encoder = nn.ModuleList(Block("attn", p) for p in encoder)
        self.patch_proj = None if patch_proj is None else _trainable(patch_proj)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def __getitem__(self, name: str):
        """A top-level group (`embed`, `unembed`, `final_norm`, `patch_proj`)
        as the forward reads it: gathered on a sharded model."""
        return sharding.gathered(getattr(self, name))


def _init_ffn(cfg: ArchConfig, generator, dtype) -> dict:
    if cfg.ffn == "moe":
        return moe.init_moe(cfg, generator, dtype)
    if cfg.ffn == "gelu":
        return layers.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    return layers.init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype)


def _apply_ffn(cfg: ArchConfig, p, x):
    """(y, aux): aux is the MoE FFN's auxiliary loss, 0.0 for the others."""
    if cfg.ffn == "moe":
        return moe.moe_ffn(cfg, p, x)
    if cfg.ffn == "gelu":
        return layers.gelu_mlp(p, x), 0.0
    return layers.swiglu(p, x), 0.0


def init_block(cfg: ArchConfig, generator, kind: str, dtype,
               with_cross: bool = False) -> dict:
    dev = generator.device
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind in ("attn", "local"):
        p["mix"] = attention.init_attention(cfg, generator, dtype)
    elif kind == "mla":
        p["mix"] = attention.init_mla(cfg, generator, dtype)
    elif kind == "rglru":
        p["mix"] = recurrent.init_rglru(cfg, generator, dtype)
    elif kind == "rwkv6":
        p["mix"] = recurrent.init_rwkv6(cfg, generator, dtype)
    else:
        raise ValueError(kind)
    p["norm2"] = layers.init_rmsnorm(cfg.d_model, dtype, dev)
    if kind == "rwkv6":
        p["ffn"] = recurrent.init_rwkv_cmix(cfg, generator, dtype)
    else:
        p["ffn"] = _init_ffn(cfg, generator, dtype)
    if with_cross:
        p["cross"] = attention.init_cross_attention(cfg, generator, dtype)
        p["norm_cross"] = layers.init_rmsnorm(cfg.d_model, dtype, dev)
    return p


def _whole(prefix: str, group: dict) -> dict:
    return group


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device | None = None, keep=_whole) -> Model:
    """Random parameters with the JAX initialisers' scales, drawn from
    `generator`, which must live on `device` (default: `cuda`).

    `keep(prefix, group)` is given each parameter group as it is drawn (the
    embedding, a block; `prefix` is its name in the model) and returns what
    the model holds of it: by default the group itself.
    `launch.shardings.init_sharded` keeps this rank's shards and frees the
    whole leaves there."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    embed = keep("embed", layers.init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype))
    unembed = (None if cfg.tied_embeddings else keep(
        "unembed", layers.init_unembed(generator, cfg.d_model, cfg.vocab_size, dtype)))
    final_norm = keep("final_norm", layers.init_rmsnorm(cfg.d_model, dtype, generator.device))
    blocks = [keep(f"blocks.{i}", init_block(cfg, generator, kind, dtype,
                                             with_cross=cfg.enc_dec))
              for i, kind in enumerate(cfg.layer_kinds)]
    encoder = ([keep(f"encoder.{i}", init_block(cfg, generator, "attn", dtype))
                for i in range(cfg.num_encoder_layers)] if cfg.enc_dec else [])
    patch_proj = (keep("patch_proj", layers.init_linear(generator, cfg.d_model, cfg.d_model,
                                                       dtype))
                  if cfg.frontend == "patch_stub" else None)
    return Model(cfg, embed, unembed, final_norm, blocks, encoder, patch_proj)


# --- caches -------------------------------------------------------------------------


def cache_cuts(cfg: ArchConfig, kind: str, tp_size: int, with_cross: bool = False) -> dict:
    """{cache leaf ("mix.k"): (dim, [the indices along dim of the whole leaf
    that 'model' rank r holds, for each r])} of a block's cache on tp_size
    'model' ranks: the local KV heads, RG-LRU channels and RWKV-6 heads
    (`tensor_parallel`); the leaves it does not name stay whole."""
    def even(n):
        return [list(range(r * n // tp_size, (r + 1) * n // tp_size)) for r in range(tp_size)]

    def kv():
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        if tp.divides(hkv, tp_size):
            return even(hkv)
        return [tp.kv_heads(hq, hkv, tp_size, r) for r in range(tp_size)]

    attn_split = tp.divides(cfg.num_heads, tp_size)
    cuts = {}
    if kind in ("attn", "local") and attn_split:
        cuts = {"mix.k": (1, kv()), "mix.v": (1, kv())}
    elif kind == "rglru" and tp.divides(cfg.rglru_width or cfg.d_model, tp_size):
        w = even(cfg.rglru_width or cfg.d_model)
        cuts = {"mix.h": (1, w), "mix.conv_tail": (2, w)}
    elif kind == "rwkv6" and tp.divides(cfg.d_model // cfg.rwkv_head_dim, tp_size):
        cuts = {"mix.wkv": (1, even(cfg.d_model // cfg.rwkv_head_dim))}
    if with_cross and attn_split:
        cuts |= {"cross_k": (1, kv()), "cross_v": (1, kv())}
    return cuts


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                     dtype, device, with_cross: bool = False, enc_seq: int = 0,
                     tp_size: int = 1) -> dict:
    """A block's cache as this rank holds it on tp_size 'model' ranks
    (`cache_cuts`)."""
    cuts = cache_cuts(cfg, kind, tp_size, with_cross)

    def local(key):
        return len(cuts[key][1][0]) if key in cuts else None

    if kind in ("attn", "local"):
        c = {"mix": attention.init_attn_cache(cfg, batch, max_seq, kind, dtype, device,
                                              kv_heads=local("mix.k"))}
    elif kind == "mla":
        c = {"mix": attention.init_mla_cache(cfg, batch, max_seq, dtype, device)}
    elif kind == "rglru":
        c = {"mix": recurrent.init_rglru_state(cfg, batch, dtype, device, width=local("mix.h"))}
    elif kind == "rwkv6":
        c = {"mix": recurrent.init_rwkv6_state(cfg, batch, dtype, device,
                                               heads=local("mix.wkv")),
             "cmix": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
    else:
        raise ValueError(kind)
    if with_cross:
        shape = (batch, local("cross_k") or cfg.num_kv_heads, enc_seq, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                device: str | torch.device | None = None, tp_size: int = 1) -> list[dict]:
    """One cache per decoder layer, in layer order, as a rank of tp_size
    'model' ranks holds it (the local heads or channels under tensor
    parallelism)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    return [init_block_cache(cfg, kind, batch, max_seq, dtype, dev,
                             with_cross=cfg.enc_dec, enc_seq=cfg.encoder_seq, tp_size=tp_size)
            for kind in cfg.layer_kinds]


# --- stack apply --------------------------------------------------------------------


# a cache leaf's sequence dim, where a sharded cache may hold it as its
# 'model' shard (`kv-seq-sharded` K/V, MLA's latent cache)
SEQ_DIMS = {"mix.k": 2, "mix.v": 2, "mix.c_kv": 1, "mix.k_rope": 1}


def _norm(p, x):
    """rmsnorm of the residual stream; on its sequence slice the scale's
    gradient is each peer's part, summed (`tensor_parallel.on_shard`)."""
    return layers.rmsnorm({"scale": tp.on_shard(p["scale"])}, x)


def apply_block(cfg: ArchConfig, p: Block, kind: str, x, positions, *, cache=None,
                enc_out=None, bidirectional: bool = False, seq: bool = False):
    """Returns (x, cache, aux); the cache is updated in place: attention
    caches by the attention blocks, recurrent states and the cross K/V here.
    aux is the MoE FFN's auxiliary loss (a float32 tensor), 0.0 for the other
    FFNs.  A block with cross attention attends to `enc_out`'s K/V where it
    is given (train, prefill: prefill also stores them in the cache) and to
    the cached ones in decode.  `seq`: x is this rank's slice of the
    sequence (sequence parallelism; `positions` stay the whole sequence's)."""
    with sharding.sequence(seq):
        return _apply_block(cfg, p, kind, x, positions, cache, enc_out, bidirectional)


def _apply_block(cfg, p, kind, x, positions, cache, enc_out, bidirectional):
    held = cache  # a sharded cache: this rank's part here, its shards kept at the end
    cut, local = {}, set()
    if cache is not None and sharding.caches_sharded():
        cache, local = sharding.gathered_cache(cache, fresh=x.shape[1] > 1, seq_dims=SEQ_DIMS)
        cuts = {k: v for k, v in cache_cuts(cfg, kind, tp.size(), "cross" in p).items()
                if k not in local}
        cache, cut = sharding.cut_cache(cache, cuts, tp.rank())
    h = _norm(p["norm1"], x)
    mix_cache = None if cache is None else cache["mix"]
    if kind in ("attn", "local"):
        y, new_mix = attention.attention_block(cfg, p["mix"], h, positions, kind=kind,
                                               cache=mix_cache, bidirectional=bidirectional)
    elif kind == "mla":
        y, new_mix = attention.mla_block(cfg, p["mix"], h, positions, cache=mix_cache)
    elif kind == "rglru":
        y, new_mix = recurrent.rglru_block(cfg, p["mix"], h, state=mix_cache)
    elif kind == "rwkv6":
        y, new_mix = recurrent.rwkv6_block(cfg, p["mix"], h, state=mix_cache)
    else:
        raise ValueError(kind)
    x = x + y
    if "cross" in p:
        hc = _norm(p["norm_cross"], x)
        if enc_out is not None:  # train / prefill: fresh encoder output
            enc_kv = attention.encode_cross_kv(cfg, p["cross"], enc_out)
            if cache is not None:  # written in place, as every cache
                cache["cross_k"].copy_(enc_kv[0])
                cache["cross_v"].copy_(enc_kv[1])
        else:  # decode: cached cross K/V
            enc_kv = (cache["cross_k"], cache["cross_v"])
        x = x + attention.cross_attention_block(cfg, p["cross"], hc, enc_kv)
    h = _norm(p["norm2"], x)
    if kind == "rwkv6":
        y, new_cmix = recurrent.rwkv_cmix(cfg, p["ffn"], h,
                                          state=None if cache is None else cache["cmix"])
        aux = 0.0
    else:
        y, aux = _apply_ffn(cfg, p["ffn"], h)
    if cache is not None:
        _keep(cache["mix"], new_mix)
        if kind == "rwkv6":
            cache["cmix"].copy_(new_cmix)
        if cut:
            cache = sharding.uncut_cache(cache, cut, tp.group())
        if cache is not held:
            sharding.keep_shards(held, cache, local)
    return sharding.shard(x + y, "act"), held, aux


def _keep(held: dict, new: dict) -> None:
    """A block's new state copied into the tensors its cache holds (the
    recurrent blocks return fresh ones; the attention blocks return the
    held dict itself, written in place), so that every cache leaf keeps its
    storage from step to step, as a captured decode step needs."""
    if new is held:
        return
    for k, t in new.items():
        held[k].copy_(t)


# --- selective remat ---------------------------------------------------------------------

# the matrix products of the model's paths as the dispatcher sees them:
# `torch.matmul` and `layers._DotF32` lower to `aten.mm` (two matrices) or
# `aten.bmm` (a leading batch dimension)
_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm)


def dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy, JAX's `dots_with_no_batch_dims_saveable`: save
    the output of a matrix product whose operands have no batch dimension
    (both are matrices: `x (N, d) @ w (d, f)`, the projections, `aten.mm` or
    its `mm.dtype` overload on the card), recompute everything else.  A
    batched product (`aten.bmm`: the MoE experts' `ecd,edf->ecf`, attention's
    `bhqd,bhkd` in the plain version) is recomputed, as JAX recomputes a
    `dot_general` with batch dimensions.  The hand-written kernels launch
    outside the dispatcher into buffers from `torch.empty_like`, which this
    policy never saves: they are recomputed with their kernel."""
    del ctx, kwargs
    if getattr(op, "overloadpacket", None) in _PRODUCTS and all(t.dim() == 2 for t in args[:2]):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


# --- public entry points ----------------------------------------------------------------


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor
    caches: list[dict] | None
    aux_loss: torch.Tensor


def _embed_inputs(cfg: ArchConfig, params: Model, batch: dict, seq: bool = False):
    """(x, positions): the token embeddings, after the projected patches
    where the frontend is `patch_stub` and the batch has `patches`; `seq`:
    x is this rank's slice of that sequence (sequence parallelism), the
    positions the whole sequence's."""
    patches = cfg.frontend == "patch_stub" and "patches" in batch
    with sharding.sequence(seq and not patches):
        x = layers.embed(params["embed"], batch["tokens"].long()) * (cfg.d_model ** 0.5)
    x = x.to(getattr(torch, cfg.dtype))
    if patches:
        px = layers.linear(params["patch_proj"], batch["patches"])
        x = torch.cat([px.to(x.dtype), x], dim=1)
        x = tp.cut(x, 1) if seq else x
    b, s = batch["tokens"].shape[0], _seq_len(cfg, batch)
    return sharding.shard(x, "act"), torch.arange(s, dtype=torch.int32,
                                                  device=x.device).expand(b, s)


def _seq_len(cfg: ArchConfig, batch: dict) -> int:
    """The decoder's sequence: the tokens, after internvl2's patches."""
    s = batch["tokens"].shape[1]
    if cfg.frontend == "patch_stub" and "patches" in batch:
        s += batch["patches"].shape[1]
    return s


def _encode(cfg: ArchConfig, params: Model, frames):
    """Whisper encoder on precomputed conv-frontend frames (B, S_enc, d),
    returned whole on every 'model' peer (under sequence parallelism the
    encoder runs on slices of the frames where they divide)."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    seq = tp.shards_sequence(s)
    x = tp.cut(x, 1) if seq else x
    for block in params.encoder:
        x, _, _ = apply_block(cfg, block, "attn", x, positions, bidirectional=True, seq=seq)
    with sharding.sequence(seq):
        return tp.enter(_norm(params["final_norm"], x), False)


def vocab_split(cfg: ArchConfig, params: Model) -> bool:
    """Whether the unembedding computes each 'model' rank's vocab slice of
    the logits (a sharded model whose vocab divides by the 'model' size)."""
    head = params.embed["table"] if cfg.tied_embeddings else params.unembed["w"]
    return getattr(head, "tp_split", False)


def forward(cfg: ArchConfig, params: Model, batch: dict, *, caches=None,
            mode: str = "train", logits_whole: bool = True) -> ModelOutput:
    """batch: tokens (B, S) [+ patches (B, P, d) | frames (B, S_enc, d)] on the
    model's device.  Logits are float32; a vocab-parallel unembedding's are
    gathered over 'model' unless `logits_whole` is False (this rank's vocab
    only: `loss_fn`, `greedy`, the dry run's logits-sharded variant).  Under
    the `seq-parallel` rule the residual stream is each rank's slice of the
    sequence where the sequence divides by the 'model' size."""
    enc_out = None
    if cfg.enc_dec and mode != "decode":
        if "frames" not in batch:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the batch needs frames")
        enc_out = _encode(cfg, params, batch["frames"])
    seq = tp.shards_sequence(_seq_len(cfg, batch))
    x, positions = _embed_inputs(cfg, params, batch, seq)
    b, s = positions.shape
    if caches is not None and mode == "decode":
        # single-token step: positions come from the caches' device counter,
        # a new tensor (no view of it), since each attention block advances
        # its own in place
        positions = torch.zeros((b, s), dtype=torch.int32, device=x.device) \
            + _cache_pos(caches, x.device)
    remat = (mode == "train" and cfg.remat and cfg.remat_policy != "none"
             and torch.is_grad_enabled())
    # as in the reference, a policy other than "dots" (and "none") is full remat
    context = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
    total_aux = 0.0
    for i, block in enumerate(params.blocks):
        cache = None if caches is None else caches[i]
        if remat:
            x, _, aux = checkpoint(apply_block, cfg, block, block.kind, x, positions,
                                   cache=cache, enc_out=enc_out, seq=seq, use_reentrant=False,
                                   **context)
        else:
            x, _, aux = apply_block(cfg, block, block.kind, x, positions, cache=cache,
                                    enc_out=enc_out, seq=seq)
        total_aux = total_aux + aux
    head = params["embed"] if cfg.tied_embeddings else params["unembed"]
    with sharding.sequence(seq):
        x = _norm(params["final_norm"], x)
        logits = sharding.shard(layers.unembed(head, x, gather=logits_whole), "logits")
    # a dense stack's is a zero made on the device, never copied from the host
    aux = (torch.as_tensor(total_aux, dtype=torch.float32, device=x.device)
           if isinstance(total_aux, torch.Tensor)
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return ModelOutput(logits=logits, caches=caches, aux_loss=aux)


def _cache_pos(caches, device) -> torch.Tensor:
    """Current decode position, a 0-d int32 tensor: the first attention
    cache's `pos` (all attention caches advance together).

    Pure-recurrent stacks (rwkv6) have no positional cache, and no use for
    positions (token shift only), so a zero on `device` is returned."""
    for c in caches:
        if "pos" in c["mix"]:
            return c["mix"]["pos"]
    return torch.zeros((), dtype=torch.int32, device=device)


def last_logits(cfg: ArchConfig, params: Model, logits, whole: bool = True):
    """The last position's logits (B, V) of a forward's (B, S, V / tp): this
    rank's vocab slice, gathered over 'model' where `whole` and the
    unembedding is vocab-split (so no (B, S, V) tensor is held)."""
    last = logits[:, -1, :]
    return tp.gather(last, -1) if whole and vocab_split(cfg, params) else last


def greedy(cfg: ArchConfig, params: Model, logits):
    """The greedy ids (B,) of logits (B, V) as `prefill` and `decode_step`
    return them with `logits_whole=False`: a vocab-split unembedding's
    vocab slices are combined over 'model'
    (`tensor_parallel.vocab_parallel_argmax`), the same ids as the argmax of
    the gathered logits."""
    if vocab_split(cfg, params):
        return tp.vocab_parallel_argmax(logits)
    return torch.argmax(logits, dim=-1)


def prefill(cfg: ArchConfig, params: Model, batch: dict, max_seq: int, *,
            logits_whole: bool = True):
    """Run the prompt (and, for whisper, encode the frames once, filling the
    cross K/V caches), build caches.  Returns (last-token logits, caches):
    with `logits_whole` False, a vocab-split unembedding's are this rank's
    vocab slice (`greedy` reads them)."""
    b = batch["tokens"].shape[0]
    # a sharded model's blocks split over the installed mesh's 'model' axis
    caches = init_caches(cfg, b, max_seq, params.device,
                         tp.size() if getattr(params, "sharded", False) else 1)
    out = forward(cfg, params, batch, caches=caches, mode="prefill", logits_whole=False)
    return last_logits(cfg, params, out.logits, logits_whole), out.caches


def decode_step(cfg: ArchConfig, params: Model, token, caches, *, logits_whole: bool = True):
    """token: (B, 1) int.  Returns (logits (B, vocab), caches), the caches
    advanced in place; `logits_whole` as `prefill`'s."""
    out = forward(cfg, params, {"tokens": token}, caches=caches, mode="decode",
                  logits_whole=False)
    return last_logits(cfg, params, out.logits, logits_whole), out.caches


def loss_fn(cfg: ArchConfig, params: Model, batch: dict, aux_weight: float = 0.01):
    """Mean next-token NLL over the label positions with `labels >= 0`, plus
    `aux_weight` times the auxiliary loss (0 for a dense model).  Returns
    (loss, {"nll", "aux"}), as `repro.models.model.loss_fn`.  Where the
    unembedding is vocab-split the NLL is computed from each rank's vocab
    slice (`tensor_parallel.vocab_parallel_nll`): the logits are never
    gathered, as the reference's logits rule keeps them sharded."""
    out = forward(cfg, params, batch, mode="train", logits_whole=False)
    labels = batch["labels"].long()
    logits = out.logits[:, -labels.shape[1]:, :].float()
    if vocab_split(cfg, params):
        per_token = tp.vocab_parallel_nll(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
        per_token = logz - gold
    mask = (labels >= 0).float()
    nll = torch.sum(per_token * mask) / torch.clamp_min(mask.sum(), 1.0)
    loss = nll + aux_weight * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}

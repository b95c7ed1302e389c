"""Attention blocks of the port: GQA (+RoPE), sliding-window, MLA, cross-attention.

The cache protocol is the JAX package's:
  prefill : attn(x full seq)            -> (y, cache)
  decode  : attn(x one token, cache)    -> (y, cache')

Cache layout (one dict per layer): k/v (B, Hkv, S_cache, hd); `slot_pos`
(S_cache,) int32, the absolute position held by each slot (-1 = empty); `pos`,
a Python int shared by the whole batch.  Global layers have S_cache = max_seq
and keep position p at slot p; sliding-window ("local") layers keep a ring
buffer of `window` slots and write position p at slot p % S_cache.

Unlike the JAX version, which returns fresh arrays, the port writes K/V into
the cache tensors in place (a full-width cache is ~1.4 GB) and returns the
same dict with `pos` and `slot_pos` advanced.

MLA (MiniCPM3): the cache holds the *latent* c_kv (B, max_seq, kv_lora_rank)
and the shared rope key k_rope (B, max_seq, qk_rope), written at `pos`.
Prefill expands the latents and runs the flash kernel (query/key head nope +
rope, value head v_head_dim, which the op pads up to the query head); decode
uses the weight-absorption trick (q_nope folded through W_uk, the output
through W_uv) in plain f32 einsums, as the JAX package does, so a step
touches only rank-r tensors.

Cross attention (whisper's decoder) attends to the encoder's K/V without a
mask: the prompt against every frame in prefill, one query in each decode
step, both through the flash kernel.

Tensor parallelism (`tensor_parallel`): where the query heads divide by the
'model' size each rank computes hq / tp of them (its columns of wq), and wo
row-parallel; the KV heads split alike where they divide, else each rank
keeps the KV heads its query heads read (`tensor_parallel.kv_heads`, from wk
and wv gathered whole).  The caches hold those local heads.  MLA splits its
heads (w_uq, w_uk, w_uv, wo), its down projections and the latent cache stay
whole.  Heads that do not divide: the block computes them all, replicated.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from . import layers
from . import tensor_parallel as tp
from .config import ArchConfig


def _decode_attend(q, k_cache, v_cache, slot_pos, q_pos, window):
    """q: (B, Hq, 1, hd); caches (B, Hkv, S, hd); slot_pos (S,) absolute
    positions per slot (-1 = empty).  Returns (B, Hq, 1, hd).  Plain PyTorch,
    f32 scores, as in the JAX package (which uses no kernel here either)."""
    b, hq, _, hd = q.shape
    hkv = k_cache.shape[1]
    group = hq // hkv
    qg = (q.float() * (hd ** -0.5)).reshape(b, hkv, group, hd)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= q_pos)
    if window is not None:
        valid &= slot_pos > q_pos - window
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def init_attention(cfg: ArchConfig, generator, dtype):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": layers.normal_init(generator, (d, hq * hd), s, dtype),
        "wk": layers.normal_init(generator, (d, hkv * hd), s, dtype),
        "wv": layers.normal_init(generator, (d, hkv * hd), s, dtype),
        "wo": layers.normal_init(generator, (hq * hd, d), (hq * hd) ** -0.5, dtype),
    }


def init_attn_cache(cfg: ArchConfig, batch: int, max_seq: int, kind: str, dtype,
                    device, kv_heads: int | None = None):
    """`kv_heads`: the KV heads this rank holds (default all of them)."""
    s_cache = min(max_seq, cfg.window) if kind == "local" else max_seq
    hkv, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, s_cache, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, s_cache, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((s_cache,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _kv_weights(cfg: ArchConfig, p):
    """wk, wv as this rank reads them: whole, its shard, or, where the query
    heads split and the KV heads do not, the columns of the KV heads its
    query heads read (`tensor_parallel.kv_heads`)."""
    wk, wv = p["wk"], p["wv"]
    if not tp.is_split(p, "wq") or tp.is_split(p, "wk"):
        return wk, wv
    hd = cfg.head_dim
    heads = tp.kv_heads(cfg.num_heads, cfg.num_kv_heads, tp.size(), tp.rank())
    if heads == list(range(heads[0], heads[-1] + 1)):
        cols = slice(heads[0] * hd, (heads[-1] + 1) * hd)
        return wk[:, cols], wv[:, cols]
    cols = torch.tensor([h * hd + i for h in heads for i in range(hd)], device=wk.device)
    return wk[:, cols], wv[:, cols]


def attention_block(cfg: ArchConfig, p, x, positions, *, kind: str, cache=None,
                    bidirectional: bool = False):
    """x: (B, S, d).  Returns (y, cache) — the cache updated in place.
    `bidirectional` (whisper's encoder) drops the causal mask."""
    b, s, d = x.shape
    hd = cfg.head_dim
    window = cfg.window if kind == "local" else None
    split = tp.is_split(p, "wq")
    xi = tp.copy(x) if split else x
    wk, wv = _kv_weights(cfg, p)
    hq, hkv = p["wq"].shape[1] // hd, wk.shape[1] // hd     # this rank's heads
    q = _split_heads(layers.dot(xi, p["wq"]).to(x.dtype), hq, hd)
    k = _split_heads(layers.dot(xi, wk).to(x.dtype), hkv, hd)
    v = _split_heads(layers.dot(xi, wv).to(x.dtype), hkv, hd).contiguous()
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and s == 1:  # decode: one token
        pos = cache["pos"]
        slot = pos % cache["k"].shape[2]  # ring buffer (== pos for global caches)
        cache["k"][:, :, slot] = k[:, :, 0]
        cache["v"][:, :, slot] = v[:, :, 0]
        cache["slot_pos"][slot] = pos
        out = _decode_attend(q, cache["k"], cache["v"], cache["slot_pos"], pos,
                             window)
        cache["pos"] = pos + 1
    else:  # training / plain forward / prefill
        out = flash_attention(q, k, v, not bidirectional, window)
        if cache is not None:  # prefill: stash the tail of k/v
            s_cache = cache["k"].shape[2]
            keep = min(s, s_cache)
            if keep == s:  # whole prefix fits: position p lives at slot p
                cache["k"][:, :, :s] = k
                cache["v"][:, :, :s] = v
                slot = torch.full((s_cache,), -1, dtype=torch.int32,
                                  device=x.device)
                slot[:s] = torch.arange(s, dtype=torch.int32, device=x.device)
            else:  # ring buffer: slot t holds the position p = t (mod s_cache)
                # from the kept tail [s - s_cache, s); decode continues at
                # slot = pos % s_cache without re-shuffling.
                idx = (torch.arange(s_cache, device=x.device) - s) % s_cache
                cache["k"].copy_(k[:, :, s - keep:][:, :, idx])
                cache["v"].copy_(v[:, :, s - keep:][:, :, idx])
                slot = (s - keep) + idx.to(torch.int32)
            cache["slot_pos"] = slot
            cache["pos"] = s

    y = out.transpose(1, 2).reshape(b, s, hq * hd)
    return layers.row_parallel(y, p["wo"], split).to(x.dtype), cache


# --- MLA (multi-head latent attention) ---------------------------------------------


def init_mla(cfg: ArchConfig, generator, dtype):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = d ** -0.5
    return {
        "w_dq": layers.normal_init(generator, (d, m.q_lora_rank), s, dtype),
        "w_uq": layers.normal_init(generator, (m.q_lora_rank, h * qk_head),
                                   m.q_lora_rank ** -0.5, dtype),
        "w_dkv": layers.normal_init(generator, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                                    s, dtype),
        "w_uk": layers.normal_init(generator, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                                   m.kv_lora_rank ** -0.5, dtype),
        "w_uv": layers.normal_init(generator, (m.kv_lora_rank, h * m.v_head_dim),
                                   m.kv_lora_rank ** -0.5, dtype),
        "wo": layers.normal_init(generator, (h * m.v_head_dim, d),
                                 (h * m.v_head_dim) ** -0.5, dtype),
    }


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, device):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "pos": 0,
    }


def mla_block(cfg: ArchConfig, p, x, positions, *, cache=None):
    """x: (B, S, d).  Returns (y, cache) — the latent cache written in place."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = p["w_uq"].shape[1] // (nope + rope_d)                     # this rank's heads
    split = tp.is_split(p, "w_uq")
    scale = (nope + rope_d) ** -0.5

    cq = layers.dot(x, p["w_dq"]).to(x.dtype)                      # (B,S,rq)
    dkv = layers.dot(x, p["w_dkv"]).to(x.dtype)                    # (B,S,rkv+rope)
    if split:  # the down projections' outputs feed every rank's heads
        cq, dkv = tp.copy(cq), tp.copy(dkv)
    q = layers.dot(cq, p["w_uq"]).to(x.dtype)
    q = q.reshape(b, s, h, nope + rope_d).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    k_rope = layers.apply_rope(k_rope[:, None], positions, cfg.rope_theta)[:, 0]

    if cache is None or s > 1:  # train / prefill: expand latents, full attention
        k_n = layers.dot(c_kv, p["w_uk"]).to(x.dtype).reshape(b, s, h, nope).transpose(1, 2)
        v = layers.dot(c_kv, p["w_uv"]).to(x.dtype).reshape(b, s, h, vd).transpose(1, 2)
        k_r = k_rope[:, None].expand(b, h, s, rope_d)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_n, k_r], dim=-1)
        out = flash_attention(q_full, k_full, v.contiguous(), True, None, scale)
        if cache is not None:
            cache["c_kv"][:, :s] = c_kv
            cache["k_rope"][:, :s] = k_rope
            cache["pos"] = s
    else:  # decode with weight absorption: attend in latent space
        pos = cache["pos"]
        cache["c_kv"][:, pos] = c_kv[:, 0]
        cache["k_rope"][:, pos] = k_rope[:, 0]
        c_all, kr_all = cache["c_kv"].float(), cache["k_rope"].float()
        w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, nope).float()
        # absorb: q_abs[b,h,r] = sum_n q_nope[b,h,n] * w_uk[r,h,n]
        q_abs = torch.einsum("bhln,rhn->bhlr", q_nope.float(), w_uk)    # (B,H,1,rkv)
        scores = torch.einsum("bhlr,bsr->bhls", q_abs, c_all)
        scores = scores + torch.einsum("bhld,bsd->bhls", q_rope.float(), kr_all)
        scores = scores * scale
        spos = torch.arange(c_all.shape[1], device=x.device)
        scores = scores.masked_fill(spos > pos, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        lat = torch.einsum("bhls,bsr->bhlr", w, c_all)
        w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, vd).float()
        out = torch.einsum("bhlr,rhv->bhlv", lat, w_uv).to(x.dtype)
        cache["pos"] = pos + 1

    y = out.transpose(1, 2).reshape(b, s, h * vd)
    return layers.row_parallel(y, p["wo"], split).to(x.dtype), cache


# --- cross attention (whisper decoder) ------------------------------------------------


def init_cross_attention(cfg: ArchConfig, generator, dtype):
    return init_attention(cfg, generator, dtype)


def cross_attention_block(cfg: ArchConfig, p, x, enc_kv):
    """x: (B, S, d); enc_kv: (k, v) each (B, Hkv, S_enc, hd), contiguous
    (this rank's KV heads, `encode_cross_kv`).  Every query attends every
    frame (no mask)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    split = tp.is_split(p, "wq")
    hq = p["wq"].shape[1] // hd
    q = _split_heads(layers.dot(tp.copy(x) if split else x, p["wq"]).to(x.dtype),
                     hq, hd).contiguous()
    k, v = enc_kv
    out = flash_attention(q, k, v, False, None)
    y = out.transpose(1, 2).reshape(b, s, hq * hd)
    return layers.row_parallel(y, p["wo"], split).to(x.dtype)


def encode_cross_kv(cfg: ArchConfig, p, enc_out):
    """The encoder output's K/V for one decoder layer, (B, Hkv, S_enc, hd)
    each: the KV heads this rank's query heads read."""
    hd = cfg.head_dim
    wk, wv = _kv_weights(cfg, p)
    e = tp.copy(enc_out) if tp.is_split(p, "wq") else enc_out
    k = _split_heads(layers.dot(e, wk).to(enc_out.dtype), wk.shape[1] // hd, hd)
    v = _split_heads(layers.dot(e, wv).to(enc_out.dtype), wv.shape[1] // hd, hd)
    return k.contiguous(), v.contiguous()

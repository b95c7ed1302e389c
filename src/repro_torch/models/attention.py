"""Attention blocks of the port: GQA (+RoPE), global or sliding window.

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

MLA and cross attention come with the slices that port their architectures.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from . import layers
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
                    device):
    s_cache = min(max_seq, cfg.window) if kind == "local" else max_seq
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, s_cache, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, s_cache, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((s_cache,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def attention_block(cfg: ArchConfig, p, x, positions, *, kind: str, cache=None):
    """x: (B, S, d).  Returns (y, cache) — the cache updated in place."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window if kind == "local" else None
    q = _split_heads(layers.dot(x, p["wq"]).to(x.dtype), hq, hd)
    k = _split_heads(layers.dot(x, p["wk"]).to(x.dtype), hkv, hd)
    v = _split_heads(layers.dot(x, p["wv"]).to(x.dtype), hkv, hd).contiguous()
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
        out = flash_attention(q, k, v, True, window)
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
    return layers.dot(y, p["wo"]).to(x.dtype), cache

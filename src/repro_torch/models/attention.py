"""Attention blocks of the port: GQA (+RoPE), sliding-window, MLA, cross-attention.

The cache protocol is the JAX package's:
  prefill : attn(x full seq)            -> (y, cache)
  decode  : attn(x one token, cache)    -> (y, cache')

Cache layout (one dict per layer): k/v (B, Hkv, S_cache, hd); `slot_pos`
(S_cache,) int32, the absolute position held by each slot (-1 = empty); `pos`,
a 0-d int32 tensor on the cache's device shared by the whole batch, as the
reference's `jnp.zeros((), jnp.int32)`.  Global layers have S_cache =
max_seq and keep position p at slot p; sliding-window ("local") layers keep a
ring buffer of `window` slots and write position p at slot p % S_cache.

Unlike the JAX version, which returns fresh arrays, the port writes every
leaf in place (a full-width cache is ~1.4 GB) and returns the same dict:
prefill sets `pos` (`fill_`), a decode step writes the new token's slot at
the tensor index `pos % S_cache` (`index_copy_`, the reference's
`dynamic_update_slice`) and advances `pos` (`add_`).  No value is read on
the host, so one decode step can be captured as a CUDA graph and replayed
(`launch.serve.CapturedDecode`): each replay reads the position the last
one left.

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
Under sequence parallelism a block reads the sequence gathered and writes
its output back to this rank's slice (`tensor_parallel.enter`, `leave`).

Sequence-sharded caches (a cache dict with `"shard": (offset, whole)`,
`models.sharding.gathered_cache`: this rank holds slots [offset, offset +
n) of the whole cache, `kv-seq-sharded` K/V or MLA's latents): decode
attends every head over this rank's slots only and combines the 'model'
peers' partial softmaxes, the flash-decoding combine GSPMD inserts (each
rank's max m_r, sum l_r and unnormalised P V in float32, rescaled by
exp(m_r - m) and summed; a rank with no valid slot adds zero).  The query
heads, and the new token's K/V where the KV heads split, are gathered over
'model' first (B H D a step, against the whole cache for a gather), and the
new token is written only by the rank whose slots hold it: every rank
writes, and a rank whose slots do not hold it writes back the row it held
(a mask from the position, not a branch on the host).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.flash_attention.ops import flash_attention
from . import layers
from . import tensor_parallel as tp
from .config import ArchConfig


def _put(leaf, dim: int, at, new, mine=None) -> None:
    """Write `new` (the leaf's shape with 1 along `dim`) into `leaf` at index
    `at` (a 0-d integer tensor) along `dim`, in place; where `mine` (a 0-d
    bool tensor) is False the slot keeps what it held."""
    idx = at.long().reshape(1)
    if mine is not None:
        new = torch.where(mine, new, leaf.index_select(dim, idx))
    leaf.index_copy_(dim, idx, new.to(leaf.dtype))


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


def _combine(m, l, o):
    """Every 'model' peer's partial softmax over its slots, combined: m
    (...,) its max (-inf: no valid slot), l (...,) its sum of exp(s - m), o
    (..., D) its unnormalised P V, all float32.  Returns the normalised
    (..., D), the same on every peer."""
    g = tp.group()
    mm = m.clone()
    dist.all_reduce(mm, op=dist.ReduceOp.MAX, group=g)
    c = torch.exp(m - mm)                               # 0 where m = -inf
    sums = torch.cat([(l * c)[..., None], o * c[..., None]], -1)
    dist.all_reduce(sums, group=g)
    return sums[..., 1:] / sums[..., :1]


def _partial_softmax(scores, valid):
    """(m, l, p) of scores (..., n) over the valid slots: the max (-inf
    where none is valid), the sum of exp(s - m) and the unnormalised
    weights (zero at an invalid slot)."""
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(-1)
    p = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, p.sum(-1), p


def _heads(t, split: bool):
    """Every rank's heads (dim 1) of this rank's `t`, where they split."""
    return tp.gather(t, 1) if split else t


def _mine(t, split: bool):
    """This rank's heads (dim 1) of every head's `t`."""
    return tp.cut(t, 1) if split else t


def _decode_sharded(cache, q, k, v, pos, window, split):
    """One decode step against a sequence-sharded cache: q (B, Hq, 1, hd)
    and the new token's k, v (B, Hkv, 1, hd) of every head, the cache's
    local slots.  Returns this rank's heads of the output, (B, hq, 1, hd)."""
    lo, whole = cache["shard"]
    n = cache["k"].shape[2]
    slot = pos % whole             # ring buffer (== pos for global caches)
    local = slot - lo
    mine = (local >= 0) & (local < n)
    _put(cache["k"], 2, local.clamp(0, n - 1), k, mine)
    _put(cache["v"], 2, local.clamp(0, n - 1), v, mine)
    _put(cache["slot_pos"], 0, slot, pos.reshape(1))
    slot_pos = cache["slot_pos"][lo:lo + n]
    b, hq, _, hd = q.shape
    hkv = k.shape[1]
    qg = (q.float() * (hd ** -0.5)).reshape(b, hkv, hq // hkv, hd)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, cache["k"].float())
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= slot_pos > pos - window
    m, l, p = _partial_softmax(scores, valid)
    o = torch.einsum("bhgs,bhsd->bhgd", p, cache["v"].float())
    out = _combine(m, l, o).reshape(b, hq, 1, hd).to(q.dtype)
    return _mine(out, split)


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
        "pos": torch.zeros((), dtype=torch.int32, device=device),
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
    # slices, not an index built on the host: a decode step copies nothing from it
    return (torch.cat([wk[:, h * hd:(h + 1) * hd] for h in heads], dim=1),
            torch.cat([wv[:, h * hd:(h + 1) * hd] for h in heads], dim=1))


def attention_block(cfg: ArchConfig, p, x, positions, *, kind: str, cache=None,
                    bidirectional: bool = False):
    """x: (B, S, d).  Returns (y, cache) — the cache updated in place.
    `bidirectional` (whisper's encoder) drops the causal mask."""
    hd = cfg.head_dim
    window = cfg.window if kind == "local" else None
    split = tp.is_split(p, "wq")
    xi = tp.enter(x, split)
    b, s = xi.shape[:2]
    sharded = cache is not None and "shard" in cache
    # against a sequence-sharded cache the new token's K/V of every KV head
    wk, wv = (p["wk"], p["wv"]) if sharded and not tp.is_split(p, "wk") else _kv_weights(cfg, p)
    hq, hkv = p["wq"].shape[1] // hd, wk.shape[1] // hd     # this rank's heads
    q = _split_heads(layers.dot(xi, p["wq"]).to(x.dtype), hq, hd)
    k = _split_heads(layers.dot(xi, wk).to(x.dtype), hkv, hd)
    v = _split_heads(layers.dot(xi, wv).to(x.dtype), hkv, hd).contiguous()
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    if sharded and s == 1:  # decode against this rank's slots of the cache
        kv_split = tp.is_split(p, "wk")
        out = _decode_sharded(cache, _heads(q, split), _heads(k, kv_split),
                              _heads(v, kv_split), cache["pos"], window, split)
        cache["pos"].add_(1)
    elif cache is not None and s == 1:  # decode: one token
        pos = cache["pos"]
        slot = pos % cache["k"].shape[2]  # ring buffer (== pos for global caches)
        _put(cache["k"], 2, slot, k)
        _put(cache["v"], 2, slot, v)
        _put(cache["slot_pos"], 0, slot, pos.reshape(1))
        out = _decode_attend(q, cache["k"], cache["v"], cache["slot_pos"], pos,
                             window)
        pos.add_(1)
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
            cache["slot_pos"].copy_(slot)
            cache["pos"].fill_(s)

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
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_block(cfg: ArchConfig, p, x, positions, *, cache=None):
    """x: (B, S, d).  Returns (y, cache) — the latent cache written in place."""
    m = cfg.mla
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = p["w_uq"].shape[1] // (nope + rope_d)                     # this rank's heads
    split = tp.is_split(p, "w_uq")
    scale = (nope + rope_d) ** -0.5

    x = tp.enter(x, False)             # on a slice: the sequence gathered
    b, s, _ = x.shape
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
            cache["pos"].fill_(s)
    else:  # decode with weight absorption: attend in latent space
        pos = cache["pos"]
        sharded = "shard" in cache
        lo, n = cache["shard"][0] if sharded else 0, cache["c_kv"].shape[1]  # this rank's slots
        if sharded:  # only the rank holding the position's slot writes it
            local = pos - lo
            at, mine = local.clamp(0, n - 1), (local >= 0) & (local < n)
        else:
            at, mine = pos, None
        _put(cache["c_kv"], 1, at, c_kv, mine)
        _put(cache["k_rope"], 1, at, k_rope, mine)
        c_all, kr_all = cache["c_kv"].float(), cache["k_rope"].float()
        w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, nope).float()
        # absorb: q_abs[b,h,r] = sum_n q_nope[b,h,n] * w_uk[r,h,n]
        q_abs = torch.einsum("bhln,rhn->bhlr", q_nope.float(), w_uk)    # (B,H,1,rkv)
        if sharded:  # every head over this rank's slots
            q_abs, q_rope = _heads(q_abs, split), _heads(q_rope, split)
        scores = torch.einsum("bhlr,bsr->bhls", q_abs, c_all)
        scores = scores + torch.einsum("bhld,bsd->bhls", q_rope.float(), kr_all)
        scores = scores * scale
        spos = torch.arange(lo, lo + n, device=x.device)
        if sharded:
            mx, sm, w = _partial_softmax(scores, spos <= pos)
            lat = _mine(_combine(mx, sm, torch.einsum("bhls,bsr->bhlr", w, c_all)), split)
        else:
            scores = scores.masked_fill(spos > pos, float("-inf"))
            w = torch.softmax(scores, dim=-1)
            lat = torch.einsum("bhls,bsr->bhlr", w, c_all)
        w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, vd).float()
        out = torch.einsum("bhlr,rhv->bhlv", lat, w_uv).to(x.dtype)
        pos.add_(1)

    y = out.transpose(1, 2).reshape(b, s, h * vd)
    return layers.row_parallel(y, p["wo"], split).to(x.dtype), cache


# --- cross attention (whisper decoder) ------------------------------------------------


def init_cross_attention(cfg: ArchConfig, generator, dtype):
    return init_attention(cfg, generator, dtype)


def cross_attention_block(cfg: ArchConfig, p, x, enc_kv):
    """x: (B, S, d); enc_kv: (k, v) each (B, Hkv, S_enc, hd), contiguous
    (this rank's KV heads, `encode_cross_kv`).  Every query attends every
    frame (no mask)."""
    hd = cfg.head_dim
    split = tp.is_split(p, "wq")
    hq = p["wq"].shape[1] // hd
    xi = tp.enter(x, split)
    b, s, _ = xi.shape
    q = _split_heads(layers.dot(xi, p["wq"]).to(x.dtype), hq, hd).contiguous()
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

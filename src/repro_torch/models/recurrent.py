"""Recurrent blocks of the port: Griffin RG-LRU (recurrentgemma) and RWKV-6.

The port of `repro.models.recurrent`, with its cast points and dtypes.  The
state protocol mirrors the attention caches:
  prefill: block(x full seq, zero state)  -> (y, state)
  decode : block(x one token, state)      -> (y, state')

The JAX blocks reach their Pallas kernels only when `use_pallas` and there is
no state; its prefill and decode always pass a state, so on its serving path
they run the reference scans in float32.  The port calls its ops with those
same inputs, and the ops pick by device: the CUDA kernel (B4, B5) for a CUDA
tensor, from the state, in prefill and in every decode step; the plain
version for a CPU tensor.

RG-LRU block (Griffin, arXiv:2402.19427):
  u = W_gate x ; v = W_in x ; v <- causal conv1d(v, k=4)
  r = sigmoid(W_a v); i = sigmoid(W_x v)
  log a_t = -c * softplus(Lambda) * r_t           (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * v_t)   [rg_lru op, f32]
  y = W_out (gelu(u) * h)
  State: h (B, W) f32, conv tail (B, k-1, W).

RWKV-6 block (Finch, arXiv:2404.05892), time-mix + channel-mix pair:
  token-shift interpolation, data-dependent decay via a small LoRA,
  wkv6 recurrence (bf16 r/k/v/log_w, f32 bonus and state), per-head group
  norm, gated output.  State: last token (B, d), wkv state (B, H, dk, dv) f32;
  the channel mix keeps its own last-token shift state.

A new state's last-token and conv-tail tensors are copies, not views of the
block's input, so that a cache does not hold the whole prompt's activations.

Tensor parallelism (`tensor_parallel`): where the RG-LRU width divides by
the 'model' size each rank runs W / tp channels (its columns of w_gate,
w_in, w_a and w_x, the last two reading v gathered over 'model', and its
conv and Lambda entries) and w_out row-parallel; RWKV-6 runs heads / tp
heads (w_r, w_k, w_v, w_g and its cut of the decay LoRA's output, the
bonus and the group norm) and w_o row-parallel; the channel mix splits
d_ff (w_k, w_v) and computes r whole.  The states hold the local channels
or heads; the last-token states stay whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rg_lru.ops import rg_lru
from ..kernels.wkv6.ops import wkv6
from . import layers
from . import tensor_parallel as tp
from .config import ArchConfig

_C_RGLRU = 8.0


def _uniform(generator, shape, lo, hi):
    x = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return x * (hi - lo) + lo


# --- Griffin RG-LRU ------------------------------------------------------------


def init_rglru(cfg: ArchConfig, generator, dtype):
    d = cfg.d_model
    w = cfg.rglru_width or d
    s = d ** -0.5
    # Lambda init so that a = sigmoid(Lambda) in (0.9, 0.999) (paper init)
    lam = _uniform(generator, (w,), 0.9, 0.999)
    return {
        "w_gate": layers.normal_init(generator, (d, w), s, dtype),
        "w_in": layers.normal_init(generator, (d, w), s, dtype),
        "conv": layers.normal_init(generator, (cfg.conv_kernel, w), 0.1, dtype),
        "w_a": layers.normal_init(generator, (w, w), w ** -0.5, dtype),
        "w_x": layers.normal_init(generator, (w, w), w ** -0.5, dtype),
        "lambda": torch.log(lam / (1 - lam)),  # logit so sigmoid(Lambda)=a, f32
        "w_out": layers.normal_init(generator, (w, d), w ** -0.5, dtype),
    }


def init_rglru_state(cfg: ArchConfig, batch: int, dtype, device, width: int | None = None):
    """`width`: the channels this rank holds (default all of them)."""
    w = width or cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype,
                                 device=device),
    }


def _causal_conv(p, v, tail):
    """v: (B, S, W); tail: (B, k-1, W) inputs preceding v.  Returns the conv
    (a sum of products in v's dtype) and the new tail."""
    kk = p["conv"].shape[0]
    ext = torch.cat([tail, v], dim=1)
    out = sum(ext[:, i:i + v.shape[1], :] * p["conv"][kk - 1 - i][None, None, :]
              for i in range(kk))
    return out.to(v.dtype), ext[:, -(kk - 1):, :].clone()


def rglru_block(cfg: ArchConfig, p, x, *, state=None):
    """x: (B, S, d).  Returns (y, new state)."""
    b, s, d = x.shape
    split = tp.is_split(p, "w_in")
    xi = tp.copy(x) if split else x
    u = layers.dot(xi, p["w_gate"]).to(x.dtype)
    v = layers.dot(xi, p["w_in"]).to(x.dtype)
    w = v.shape[-1]                                   # this rank's channels
    conv, lam = p["conv"], p["lambda"]
    if split:
        conv, lam = layers.local_cols(conv, w), layers.local_cols(lam, w)
    tail = state["conv_tail"] if state is not None else \
        torch.zeros((b, cfg.conv_kernel - 1, w), dtype=v.dtype, device=x.device)
    v, new_tail = _causal_conv({"conv": conv}, v, tail)

    vw = tp.copy(tp.gather(v, -1)) if split else v    # w_a, w_x read every channel
    r = torch.sigmoid(layers.dot(vw, p["w_a"]))
    i = torch.sigmoid(layers.dot(vw, p["w_x"]))
    log_a = -_C_RGLRU * F.softplus(lam)[None, None, :] * r
    a = torch.exp(log_a)
    gated = i * v.float()
    binp = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated

    h0 = state["h"] if state is not None else None
    y, h_last = rg_lru(a, binp, h0)
    out = layers.row_parallel(F.gelu(u.float(), approximate="tanh").to(x.dtype) * y.to(x.dtype),
                              p["w_out"], split).to(x.dtype)
    return out, {"h": h_last, "conv_tail": new_tail}


# --- RWKV-6 ---------------------------------------------------------------------


def init_rwkv6(cfg: ArchConfig, generator, dtype):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    heads = d // hd
    s = d ** -0.5
    lora = max(32, d // 64)
    dev = generator.device
    return {
        "mu": _uniform(generator, (5, d), 0.25, 0.75),
        "w_r": layers.normal_init(generator, (d, d), s, dtype),
        "w_k": layers.normal_init(generator, (d, d), s, dtype),
        "w_v": layers.normal_init(generator, (d, d), s, dtype),
        "w_g": layers.normal_init(generator, (d, d), s, dtype),
        "w_o": layers.normal_init(generator, (d, d), s, dtype),
        "decay_base": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "decay_A": layers.normal_init(generator, (d, lora), s, dtype),
        "decay_B": layers.normal_init(generator, (lora, d), lora ** -0.5, dtype),
        "bonus_u": layers.normal_init(generator, (heads, hd), 0.1, torch.float32),
        "ln_scale": torch.ones((heads, hd), dtype=torch.float32, device=dev),
        "ln_bias": torch.zeros((heads, hd), dtype=torch.float32, device=dev),
    }


def init_rwkv6_state(cfg: ArchConfig, batch: int, dtype, device, heads: int | None = None):
    """`heads`: the heads this rank holds (default all of them)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {
        "last": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, heads or d // hd, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x, last):
    """shifted[t] = x[t-1]; shifted[0] = last (previous chunk's final token)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(scale, bias, y):
    """y: (B, H, T, hd) per-head layernorm."""
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    return yn * scale[None, :, None, :] + bias[None, :, None, :]


def rwkv6_block(cfg: ArchConfig, p, x, *, state=None):
    """x: (B, S, d).  Returns (y, new state)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    split = tp.is_split(p, "w_r")
    dl = p["w_r"].shape[1]                            # this rank's channels
    heads = dl // hd
    last = state["last"] if state is not None else \
        torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)
    xi, xsi = (tp.copy(x), tp.copy(xs)) if split else (x, xs)

    def mix(i):
        return (xi + (xsi - xi) * p["mu"][i][None, None, :]).to(x.dtype)

    def mine(t, dim=-1):  # this rank's heads (or channels) of a leaf read whole
        return layers.local_cols(t, t.shape[dim] * dl // d, dim) if split else t

    r = layers.dot(mix(0), p["w_r"]).to(x.dtype)
    k = layers.dot(mix(1), p["w_k"]).to(x.dtype)
    v = layers.dot(mix(2), p["w_v"]).to(x.dtype)
    g = layers.dot(mix(3), p["w_g"])
    dec = layers.dot(torch.tanh(layers.dot(mix(4), p["decay_A"])).to(x.dtype),
                     mine(p["decay_B"]))
    log_w = -torch.exp(mine(p["decay_base"])[None, None, :] + dec)   # (B,S,d) <= 0

    def heads_of(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2).contiguous()
    rh, kh, vh, lwh = heads_of(r), heads_of(k), heads_of(v), heads_of(log_w.to(x.dtype))

    s0 = state["wkv"] if state is not None else None
    y, s_last = wkv6(rh, kh, vh, lwh, mine(p["bonus_u"], 0), s0)
    y = _group_norm(mine(p["ln_scale"], 0), mine(p["ln_bias"], 0), y.float())
    y = y.transpose(1, 2).reshape(b, s, dl)
    out = layers.row_parallel((F.silu(g) * y).to(x.dtype), p["w_o"], split).to(x.dtype)
    return out, {"last": x[:, -1, :].clone(), "wkv": s_last}


# --- RWKV channel mix ------------------------------------------------------------


def init_rwkv_cmix(cfg: ArchConfig, generator, dtype):
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "mu": _uniform(generator, (2, d), 0.25, 0.75),
        "w_k": layers.normal_init(generator, (d, dff), d ** -0.5, dtype),
        "w_v": layers.normal_init(generator, (dff, d), dff ** -0.5, dtype),
        "w_r": layers.normal_init(generator, (d, d), d ** -0.5, dtype),
    }


def rwkv_cmix(cfg: ArchConfig, p, x, *, state=None):
    """x: (B, S, d).  Returns (y, new last-token state)."""
    b, s, d = x.shape
    last = state if state is not None else \
        torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, last)

    def mix(i):
        return (x + (xs - x) * p["mu"][i][None, None, :]).to(x.dtype)
    split = tp.is_split(p, "w_k")      # d_ff over 'model'; r whole on every rank
    xk = tp.copy(mix(0)) if split else mix(0)
    k = torch.square(F.relu(layers.dot(xk, p["w_k"]))).to(x.dtype)
    r = torch.sigmoid(layers.dot(mix(1), p["w_r"]))
    out = (r * layers.row_parallel(k, p["w_v"], split)).to(x.dtype)
    return out, x[:, -1, :].clone()

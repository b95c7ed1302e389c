"""Plain reference of the RWKV-6 ("Finch") stack that the `rwkv6`
configurations run, in float32 (or the control's fp8 products, see
`common`), with no kernel, cache, state hand-over or batching of the program
under test: one pass over the whole sequence from zero states.

The equations are the program's block as the configuration file lists it
(its `assumed` departures from the published model included), per layer:

  h = RMSNorm(x)                       (eps 1e-6, a scale)
  h' = h shifted one token (zeros before the first); mix_i = h + (h' - h) mu_i
  r, k, v, g = mix_0 W_r, mix_1 W_k, mix_2 W_v, mix_3 W_g
  log w = -exp(decay_base + tanh(mix_4 A) B)
  per head of hd channels, from S = 0:
      y_t = r_t^T (S + (u * k_t) v_t^T);  S <- diag(w_t) S + k_t v_t^T
  y = LayerNorm over each head's hd channels (eps 1e-5) * ln_scale + ln_bias
  x = x + (SiLU(g) * y) W_o
  h = RMSNorm(x); h' shifted as above; mix_i = h + (h' - h) mu'_i
  x = x + sigmoid(mix_1 W_r') * (relu(mix_0 W_k')^2 W_v')

after the token embedding times sqrt(d), and a final RMSNorm and untied
unembedding to float32 logits.  The weights are the benchmark's (`draw`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import mm, rmsnorm

EPS = 1e-6


def _normal(gen, shape, scale, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype).mul_(scale)


def _uniform(gen, shape, lo, hi):
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(hi - lo).add_(lo)


def draw(arch: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights with the program's initial scales: N(0, fan_in^-1/2)
    projections in `dtype`; the token-shift mixes U(0.25, 0.75), the decay
    base -2, the bonus N(0, 0.1^2), the group norm's unit scale and zero
    bias, all float32; unit RMSNorm scales."""
    d, v, n = arch["d_model"], arch["vocab_size"], arch["num_layers"]
    hd, dff, lora = arch["rwkv_head_dim"], arch["d_ff"], arch["decay_lora"]
    heads, f32, dev = d // hd, torch.float32, gen.device
    embed = _normal(gen, (v, d), d ** -0.5, dtype)
    unembed = _normal(gen, (d, v), d ** -0.5, dtype)
    mu = _uniform(gen, (n, 5, d), 0.25, 0.75)
    sq = _normal(gen, (n, 5, d, d), d ** -0.5, dtype)      # w_r, w_k, w_v, w_g, w_o
    dec_a = _normal(gen, (n, d, lora), d ** -0.5, dtype)
    dec_b = _normal(gen, (n, lora, d), lora ** -0.5, dtype)
    bonus = _normal(gen, (n, heads, hd), 0.1, f32)
    cmu = _uniform(gen, (n, 2, d), 0.25, 0.75)
    ck = _normal(gen, (n, d, dff), d ** -0.5, dtype)
    cv = _normal(gen, (n, dff, d), dff ** -0.5, dtype)
    cr = _normal(gen, (n, d, d), d ** -0.5, dtype)
    ones = torch.ones((2 * n + 1, d), dtype=dtype, device=dev)
    base = torch.full((n, d), -2.0, dtype=f32, device=dev)
    ln_scale = torch.ones((n, heads, hd), dtype=f32, device=dev)
    ln_bias = torch.zeros((n, heads, hd), dtype=f32, device=dev)
    blocks = [{"norm1": {"scale": ones[2 * i]},
               "mix": {"mu": mu[i], "w_r": sq[i, 0], "w_k": sq[i, 1], "w_v": sq[i, 2],
                       "w_g": sq[i, 3], "w_o": sq[i, 4], "decay_base": base[i],
                       "decay_A": dec_a[i], "decay_B": dec_b[i], "bonus_u": bonus[i],
                       "ln_scale": ln_scale[i], "ln_bias": ln_bias[i]},
               "norm2": {"scale": ones[2 * i + 1]},
               "ffn": {"mu": cmu[i], "w_k": ck[i], "w_v": cv[i], "w_r": cr[i]}}
              for i in range(n)]
    return {"embed": {"table": embed}, "unembed": {"w": unembed},
            "final_norm": {"scale": ones[-1]}, "blocks": blocks}


def _shift(h):
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, w, u):
    """The recurrence from a zero state, a step at a time: r, k, v, w (B, H,
    T, hd) float32, u (H, hd).  Returns y (B, H, T, hd)."""
    b, h, t, n = r.shape
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    uu = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, i], s + uu * kv))
        s = w[:, :, i, :, None] * s + kv
    return torch.stack(ys, dim=2)


def block(arch: dict, p: dict, x, prec: str):
    """One layer (time mix, then channel mix) on x (B, S, d) float32."""
    b, s, d = x.shape
    hd = arch["rwkv_head_dim"]
    m, f = p["mix"], p["ffn"]
    h = rmsnorm(x, p["norm1"]["scale"], EPS)
    hs = _shift(h)
    mix = [h + (hs - h) * m["mu"][i].float() for i in range(5)]
    r = mm(mix[0], m["w_r"], prec)
    k = mm(mix[1], m["w_k"], prec)
    v = mm(mix[2], m["w_v"], prec)
    g = mm(mix[3], m["w_g"], prec)
    log_w = -torch.exp(m["decay_base"].float()
                       + mm(torch.tanh(mm(mix[4], m["decay_A"], prec)), m["decay_B"], prec))

    def heads(t):
        return t.reshape(b, s, d // hd, hd).transpose(1, 2)

    y = wkv(heads(r), heads(k), heads(v), torch.exp(heads(log_w)), m["bonus_u"])
    mu_ = y.mean(-1, keepdim=True)
    var = ((y - mu_) ** 2).mean(-1, keepdim=True)
    y = (y - mu_) * torch.rsqrt(var + 1e-5) * m["ln_scale"].float()[None, :, None] \
        + m["ln_bias"].float()[None, :, None]
    x = x + mm(F.silu(g) * y.transpose(1, 2).reshape(b, s, d), m["w_o"], prec)
    h = rmsnorm(x, p["norm2"]["scale"], EPS)
    hs = _shift(h)
    kk = torch.square(F.relu(mm(h + (hs - h) * f["mu"][0].float(), f["w_k"], prec)))
    rr = torch.sigmoid(mm(h + (hs - h) * f["mu"][1].float(), f["w_r"], prec))
    return x + rr * mm(kk, f["w_v"], prec)


def hidden(arch: dict, tree: dict, tokens, prec: str):
    """The final-normed residual stream (B, S, d) float32."""
    x = tree["embed"]["table"][tokens.long()].float() * arch["d_model"] ** 0.5
    for p in tree["blocks"]:
        x = block(arch, p, x, prec)
    return rmsnorm(x, tree["final_norm"]["scale"], EPS)


def logits(arch: dict, tree: dict, x, prec: str):
    return mm(x, tree["unembed"]["w"], prec)


def token_flops(arch: dict) -> int:
    """Forward FLOPs a token: 2 N for the N weights that enter products, and
    the recurrence's readout r^T (S + u k v^T), 2 hd^2 a head and layer."""
    d, n, dff, lora = arch["d_model"], arch["num_layers"], arch["d_ff"], arch["decay_lora"]
    hd = arch["rwkv_head_dim"]
    weights = n * (5 * d * d + 2 * d * lora + 2 * d * dff + d * d) + d * arch["vocab_size"]
    return 2 * weights + n * (d // hd) * 2 * hd * hd

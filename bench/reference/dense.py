"""Plain reference of the dense decoder that the `dense` configurations run:
pre-norm blocks of causal multi-head attention with rotary positions and a
SwiGLU feed-forward, in float32 (or the control's fp8 products, see
`common`), with no kernel, cache or batching of the program under test.

The equations are the program's block as the configuration file lists it
(its `assumed` departures from the published model included): the token
embedding times sqrt(d); RMSNorm with eps 1e-6 and a scale; q, k, v
projections without bias; rotary angles pos * theta^(-2i/hd) applied to
interleaved pairs (x[2i], x[2i+1]); softmax(q k^T / sqrt(hd)) over the
causal keys, K/V heads shared by groups of query heads; the output
projection; SiLU(x W_gate) * (x W_up) W_down; a final RMSNorm and an untied
unembedding to float32 logits.  The loss is the mean next-token NLL.

The weights are the benchmark's: `draw` makes them from a generator in a few
large calls, in the layout {embed, unembed, final_norm, blocks: [{norm1,
mix, norm2, ffn}]} that both sides read.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import mm, rmsnorm

EPS = 1e-6


def _stack(gen, layers, shape, scale, dtype):
    x = torch.randn((layers, *shape), generator=gen, device=gen.device, dtype=dtype)
    return x.mul_(scale)


def draw(arch: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights with the program's initial scales: N(0, fan_in^-1/2)
    projections, unit norm scales."""
    d, v, layers = arch["d_model"], arch["vocab_size"], arch["num_layers"]
    hq, hkv = arch["num_heads"], arch["num_kv_heads"]
    hd, dff = d // hq, arch["d_ff"]
    dev = gen.device
    embed = _stack(gen, 1, (v, d), d ** -0.5, dtype)[0]
    unembed = _stack(gen, 1, (d, v), d ** -0.5, dtype)[0]
    wq = _stack(gen, layers, (d, hq * hd), d ** -0.5, dtype)
    wk = _stack(gen, layers, (d, hkv * hd), d ** -0.5, dtype)
    wv = _stack(gen, layers, (d, hkv * hd), d ** -0.5, dtype)
    wo = _stack(gen, layers, (hq * hd, d), (hq * hd) ** -0.5, dtype)
    wg = _stack(gen, layers, (d, dff), d ** -0.5, dtype)
    wu = _stack(gen, layers, (d, dff), d ** -0.5, dtype)
    wd = _stack(gen, layers, (dff, d), dff ** -0.5, dtype)
    ones = torch.ones((2 * layers + 1, d), dtype=dtype, device=dev)
    blocks = [{"norm1": {"scale": ones[2 * i]},
               "mix": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
               "norm2": {"scale": ones[2 * i + 1]},
               "ffn": {"w_gate": wg[i], "w_up": wu[i], "w_down": wd[i]}}
              for i in range(layers)]
    return {"embed": {"table": embed}, "unembed": {"w": unembed},
            "final_norm": {"scale": ones[-1]}, "blocks": blocks}


def _rope(x, theta):
    """x (B, H, S, hd) float32 at positions 0..S-1, interleaved pairs."""
    s, hd = x.shape[2], x.shape[3]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _attention(q, k, v, prec):
    """Causal softmax attention, (B, H, S, hd) each, K/V repeated over the
    query heads of their group."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    s = q.shape[2]
    scores = mm(q, k.transpose(-1, -2), prec) * q.shape[-1] ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(probs, v, prec)


def block(arch: dict, p: dict, x, prec: str):
    """One layer on the residual stream x (B, S, d) float32."""
    b, s, d = x.shape
    hq, hkv = arch["num_heads"], arch["num_kv_heads"]
    hd = d // hq
    m = p["mix"]
    h = rmsnorm(x, p["norm1"]["scale"], EPS)

    def heads(t, n):
        return t.reshape(b, s, n, hd).transpose(1, 2)

    q = _rope(heads(mm(h, m["wq"], prec), hq), arch["rope_theta"])
    k = _rope(heads(mm(h, m["wk"], prec), hkv), arch["rope_theta"])
    o = _attention(q, k, heads(mm(h, m["wv"], prec), hkv), prec)
    x = x + mm(o.transpose(1, 2).reshape(b, s, hq * hd), m["wo"], prec)
    h = rmsnorm(x, p["norm2"]["scale"], EPS)
    f = p["ffn"]
    u = F.silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_up"], prec)
    return x + mm(u, f["w_down"], prec)


def hidden(arch: dict, tree: dict, tokens, prec: str, remat: bool = False):
    """The final-normed residual stream (B, S, d) float32; `remat`
    recomputes each layer in the backward (memory only)."""
    x = tree["embed"]["table"][tokens.long()].float() * arch["d_model"] ** 0.5
    for p in tree["blocks"]:
        if remat:
            x = checkpoint(block, arch, p, x, prec, use_reentrant=False)
        else:
            x = block(arch, p, x, prec)
    return rmsnorm(x, tree["final_norm"]["scale"], EPS)


def logits(arch: dict, tree: dict, x, prec: str):
    return mm(x, tree["unembed"]["w"], prec)


def nll_sum(arch: dict, tree: dict, tokens, labels, prec: str, remat: bool = False):
    """The summed next-token NLL of the rows (float32)."""
    z = logits(arch, tree, hidden(arch, tree, tokens, prec, remat), prec)
    gold = torch.gather(z, -1, labels.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(z, dim=-1) - gold)


def step_flops(arch: dict, batch: int, seq: int, causal: bool = True) -> int:
    """Model FLOPs of one training step (forward and backward, no remat
    recompute): 6 N a token for the N weights that enter products, and
    12 hd a head and layer for every (query, key) pair attention keeps
    (QK^T and PV, 2 hd each in the forward, twice that in the backward)."""
    d, hq, hkv, n = arch["d_model"], arch["num_heads"], arch["num_kv_heads"], arch["num_layers"]
    hd = d // hq
    weights = n * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * arch["d_ff"]) \
        + d * arch["vocab_size"]
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    return 6 * weights * batch * seq + 12 * n * batch * hq * pairs * hd

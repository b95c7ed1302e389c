"""Mixture-of-Experts FFN of the port: top-k routing and capacity-bounded
one-hot dispatch, the port of `repro.models.moe`.

GShard-style dense dispatch: tokens are processed in groups of
`group_size`; in each group every expert takes at most C = max(4,
ceil(G k cf / E)) (token, choice) pairs, in token-major order, and the rest
are dropped.  Arctic-style dense residual: an always-on SwiGLU FFN added in
parallel with the routed experts (`cfg.moe.dense_residual_d_ff > 0`).
Returns a Switch-style auxiliary load-balancing loss as well.

The reference builds the one-hot dispatch tensor (G, k, E, C) and contracts
it over g and k.  A token's k choices name k distinct experts, so for each
(token, expert, slot) at most one choice is nonzero: the port scatters the
same ones straight into the tensor summed over k, (G, E, C), which the
products then read (E C G d 2 FLOPs a product, not k times that).  The
dispatch product copies each kept token to its slot, and so is exact in any
order.  Every expert runs its C slots whether they are filled or not, as in
the reference, so a step reads every expert's weights.

The group axis is a leading batch axis of `_moe_groups`: groups run one
after another (`vectorize_groups=False`, the reference's `lax.map`) or all
at once (`jax.vmap`), with the same arithmetic per group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers
from .config import ArchConfig, MoEConfig


def init_moe(cfg: ArchConfig, generator: torch.Generator, dtype) -> dict:
    """Router (f32) and stacked (E, ...) expert weights, with the reference's
    scales; Arctic's dense residual SwiGLU under "dense"."""
    m, d = cfg.moe, cfg.d_model
    s_in, s_ff = d ** -0.5, m.d_ff_expert ** -0.5
    e, f = m.num_experts, m.d_ff_expert
    p = {
        "router": layers.normal_init(generator, (d, e), s_in, torch.float32),
        "w_gate": layers.normal_init(generator, (e, d, f), s_in, dtype),
        "w_up": layers.normal_init(generator, (e, d, f), s_in, dtype),
        "w_down": layers.normal_init(generator, (e, f, d), s_ff, dtype),
    }
    if m.dense_residual_d_ff:
        p["dense"] = layers.init_swiglu(generator, d, m.dense_residual_d_ff, dtype)
    return p


def _capacity(group: int, m: MoEConfig) -> int:
    c = int(math.ceil(group * m.top_k * m.capacity_factor / m.num_experts))
    return max(4, c)


def route(p, xg, m: MoEConfig):
    """Routing of groups xg (n, G, d): (probs (n, G, E) f32, top_p (n, G, k)
    renormalised, top_i (n, G, k), pos (n, G, k) each choice's slot in its
    expert, keep (n, G, k) bool: pos < C)."""
    n, g, _ = xg.shape
    k = m.top_k
    probs = torch.softmax(layers.dot(xg, p["router"]), dim=-1)          # (n, G, E) f32
    # a stable descending sort puts equal probabilities in index order, as
    # jax.lax.top_k does (the zero rows that pad a group tie on every expert)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # position of each (token, choice) within its expert, token-major order:
    # the running count of the choices routed to each expert, scanned along
    # the last axis (on the card a scan along the token axis of a
    # (G k, E) one-hot took 1.5 ms a group, PERF.md), read at each choice
    flat_i = top_i.reshape(n, 1, g * k)
    oh = torch.arange(m.num_experts, device=xg.device)[:, None] == flat_i   # (n, E, G*k)
    counts = torch.cumsum(oh, dim=-1, dtype=torch.int32)
    pos = (torch.gather(counts, 1, flat_i) - 1).reshape(n, g, k)
    return probs, top_p, top_i, pos, pos < _capacity(g, m)


def _moe_groups(p, xg, m: MoEConfig):
    """xg: (n, G, d), n groups.  Returns (yg (n, G, d), aux (n,))."""
    n, g, d = xg.shape
    e, k, dtype = m.num_experts, m.top_k, xg.dtype
    c = _capacity(g, m)
    probs, top_p, top_i, pos, keep = route(p, xg, m)

    # the one-hot dispatch (G, k, E, C) summed over k, as (G, E * C): each
    # kept choice puts a one at its expert's slot (dropped ones add zero)
    slot = top_i * c + torch.clamp_max(pos, c - 1)                      # (n, G, k)
    keep_x = keep.to(dtype)
    disp = torch.zeros((n, g, e * c), dtype=dtype, device=xg.device)
    disp = disp.scatter_add(2, slot, keep_x)
    xe = torch.matmul(disp.mT, xg)                                      # (n, E*C, d)
    # experts: (E, n*C, d) @ (E, d, f), f32 accumulation
    xe = xe.reshape(n, e, c, d).transpose(0, 1).reshape(e, n * c, d)
    h = layers.dot(xe, p["w_gate"])
    u = layers.dot(xe, p["w_up"])
    ye = layers.dot((F.silu(h) * u).to(dtype), p["w_down"]).to(dtype)
    ye = ye.reshape(e, n, c, d).transpose(0, 1).reshape(n, e * c, d)

    combine = torch.zeros((n, g, e * c), dtype=dtype, device=xg.device)
    combine = combine.scatter_add(2, slot, top_p.to(dtype) * keep_x)
    yg = torch.matmul(combine, ye)                                      # (n, G, d)

    # Switch aux loss terms: fraction routed per expert x mean router prob
    frac = F.one_hot(top_i, e).float().sum(dim=(1, 2)) / (g * k)       # (n, E)
    aux = e * torch.sum(frac * probs.mean(dim=1), dim=-1)
    return yg, aux


def moe_ffn(cfg: ArchConfig, p, x):
    """x: (B, S, d).  Returns (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    gs = min(m.group_size, flat.shape[0])
    pad = (-flat.shape[0]) % gs
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    groups = flat.reshape(-1, gs, d)
    if m.vectorize_groups or groups.shape[0] == 1:
        y, aux = _moe_groups(p, groups, m)
    else:  # one group after another
        outs = [_moe_groups(p, groups[i:i + 1], m) for i in range(groups.shape[0])]
        y, aux = (torch.cat(t) for t in zip(*outs, strict=True))
    y = y.reshape(-1, d)
    if pad:
        y = y[:-pad]
    y = y.reshape(b, s, d)
    if "dense" in p:  # Arctic dense residual
        y = y + layers.swiglu(p["dense"], x)
    return y, torch.mean(aux)

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

Groups across ranks.  The reference's `gspmd` step runs `moe_ffn` on the
global batch, so its groups are cut from the global token order (rows in
order, then positions).  Where the launcher installs a `TokenSplit` (the
port's `gspmd` on several ranks, on a mesh or not; `models.sharding`), rank
i holds tokens [i t, (i + 1) t) of that order, and the port forms the same
groups:
  - a rank whose t tokens are a whole number of groups dispatches them as
    it would alone;
  - otherwise (a group spans ranks: t is not a multiple of the group) the
    ranks gather every rank's tokens (an all-gather over the split, whose
    backward sums the gathered gradient back to each rank's rows), cut the
    global groups, run the groups that hold any of their rows, and each
    keeps its own rows of the output.  Under expert parallelism a rank runs
    the groups that hold rows of any rank of its 'model' group (the same
    groups on every peer, so that their exchanges pair up); a group without
    rows of its own adds nothing to its output, gradients or aux loss.
The Switch aux loss is a mean over the global groups, which is not a mean
of per-rank means when groups span ranks; each rank returns its share in
the form whose mean over ranks is the global mean: n / n_groups times the
sum of its groups' terms, each weighted by the fraction of the group's
tokens that are its own (1 for a rank holding whole groups alone: its own
mean).  The capacity C follows the global group size.  Without a split (one
rank, and the `bridge` modes, whose reference runs `loss_fn` per shard
inside `shard_map`) the groups are the rank's own.

Expert parallelism.  On a mesh with a 'model' axis the expert stacks stay
sharded over it (E/tp experts a rank, `launch.shardings`) and the split
names the 'model' group.  Each rank dispatches its groups to (E, n C, d)
slots, regroups them as (tp, E/tp, n C, d) and exchanges them with the
Bruck all-to-all (`collectives.bruck_all_to_all`, differentiable), runs its
E/tp experts over the slots of every peer, exchanges the results back and
combines: the All-to-All that the reference's GSPMD lowers its dispatch
to.  With tp = 1 the exchange returns its input and the arithmetic is the
unsharded path's.

Tensor parallelism.  The 'model' peers of a data shard hold the same rows
(`models.tensor_parallel`).  At its entry the MoE cuts the flattened tokens
over 'model' (rank (data j, model m) then holds the tokens that rank
j tp + m would hold with the rows split over every rank, in the global
token order), runs the groups, the exchange and the aux weights on that
cut as above, and gathers its output over 'model' at the exit (backward:
this rank's slice; the gradient there is the same on every peer).  The aux
loss is averaged over the peers, so every peer reports the whole batch's
and its gradient is counted once.  Where the tokens do not divide by tp,
every peer runs them all (serving only: the expert stacks' gradients would
be counted tp times).  Arctic's dense residual reads the whole rows, as a
tensor-parallel SwiGLU.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.collectives import bruck_all_to_all

from . import layers, sharding
from . import tensor_parallel as tp
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


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of `group`, in rank order.  The backward sums the
    gathered gradient over the group (an all-reduce) and keeps this rank's
    rows: a reduce-scatter's result, on any backend and group
    (`torch.distributed.nn`'s all-gather scatters its gradient on gloo by
    global ranks, which a subgroup refuses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n, ctx.rank = group, dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n)[ctx.rank], None


def _experts(p, xe, dtype):
    """The expert FFNs on their slots: xe (E, rows, d) -> (E, rows, d)."""
    h = layers.dot(xe, p["w_gate"])
    u = layers.dot(xe, p["w_up"])
    return layers.dot((F.silu(h) * u).to(dtype), p["w_down"]).to(dtype)


def _expert_parallel(p, xe, dtype, group):
    """`_experts` with this rank's E/tp experts: every rank's slots for them
    come in through the all-to-all over `group` and their results go back."""
    tp = dist.get_world_size(group)
    e, rows, d = xe.shape
    mine = bruck_all_to_all(xe.reshape(tp, e // tp, rows, d), group)  # (peer, E/tp, ...)
    ye = _experts(p, mine.transpose(0, 1).reshape(e // tp, tp * rows, d), dtype)
    back = ye.reshape(e // tp, tp, rows, d).transpose(0, 1).contiguous()
    return bruck_all_to_all(back, group).reshape(e, rows, d)


def _moe_groups(p, xg, m: MoEConfig, experts_group=None):
    """xg: (n, G, d), n groups.  Returns (yg (n, G, d), aux (n,)).  With
    `experts_group`, `p`'s expert stacks are this rank's E/tp experts of
    that group (expert parallelism)."""
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
    ye = (_experts(p, xe, dtype) if experts_group is None else
          _expert_parallel(p, xe, dtype, experts_group))
    ye = ye.reshape(e, n, c, d).transpose(0, 1).reshape(n, e * c, d)

    combine = torch.zeros((n, g, e * c), dtype=dtype, device=xg.device)
    combine = combine.scatter_add(2, slot, top_p.to(dtype) * keep_x)
    yg = torch.matmul(combine, ye)                                      # (n, G, d)

    # Switch aux loss terms: fraction routed per expert x mean router prob
    frac = F.one_hot(top_i, e).float().sum(dim=(1, 2)) / (g * k)       # (n, E)
    aux = e * torch.sum(frac * probs.mean(dim=1), dim=-1)
    return yg, aux


def _grouped(p, flat, gs: int, m: MoEConfig, experts_group):
    """flat (t, d) cut into groups of gs (the last zero-padded).  Returns
    (y (t, d), aux (groups,))."""
    d = flat.shape[1]
    pad = (-flat.shape[0]) % gs
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    groups = flat.reshape(-1, gs, d)
    if m.vectorize_groups or groups.shape[0] == 1:
        y, aux = _moe_groups(p, groups, m, experts_group)
    else:  # one group after another
        outs = [_moe_groups(p, groups[i:i + 1], m, experts_group)
                for i in range(groups.shape[0])]
        y, aux = (torch.cat(t) for t in zip(*outs, strict=True))
    y = y.reshape(-1, d)
    return (y[:-pad] if pad else y), aux


def _experts_group(p, m: MoEConfig, split):
    """The expert-parallel group where `p`'s stacks are this rank's E/n
    experts of the split's expert group (serving on a mesh, with no split:
    the 'model' group), else None."""
    group = tp.group() if split is None else split.experts
    e_local = p["w_gate"].shape[0]
    n = 1 if group is None else dist.get_world_size(group)
    if group is not None and e_local * n == m.num_experts:
        return group
    if e_local == m.num_experts:  # unsharded, or the rule's guard left E whole
        return None
    raise ValueError(f"{e_local} experts a rank over {n} ranks, of {m.num_experts}")


def _same_ranks(a, b) -> bool:
    return a is not None and b is not None and \
        dist.get_process_group_ranks(a) == dist.get_process_group_ranks(b)


def _peers(group, ep) -> list[int]:
    """The ranks, in `group` (the token holders; None: the world), of the
    expert-parallel group `ep`.  A peer outside `group` (the rows split over
    fewer ranks than the world) holds this rank's tokens, which this rank's
    own index already names."""
    ranks = dist.get_process_group_ranks(ep)
    if group is None:
        return ranks
    mine = set(dist.get_process_group_ranks(group))
    return [dist.get_group_rank(group, r) for r in ranks if r in mine]


def moe_ffn(cfg: ArchConfig, p, x):
    """x: (B, S, d).  Returns (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    split = sharding.token_split()
    ep = _experts_group(p, m, split)
    tpg = tp.group()
    cut = _same_ranks(ep, tpg) and flat.shape[0] % tp.size() == 0
    if _same_ranks(ep, tpg) and not cut and torch.is_grad_enabled():
        raise ValueError(f"{flat.shape[0]} tokens a rank do not divide over the "
                         f"{tp.size()} 'model' peers that run the experts")
    if cut:
        flat = tp.cut(flat, 0)
        y, aux = _moe_tokens(p, flat, m, _holders(split, tpg), ep)
        y = tp.gather(y, 0)
        aux = tp.reduce(aux) / tp.size()
    else:
        y, aux = _moe_tokens(p, flat, m, None if split is None else split.group,
                             ep, alone=split is None)
    y = y.reshape(b, s, d)
    if "dense" in p:  # Arctic dense residual
        y = y + layers.swiglu(p["dense"], x)
    return y, aux


def _holders(split, tpg):
    """The group whose ranks hold the cut tokens in the global token order:
    the whole world where the rows lie over the batch axes (rank j tp + m
    holds cut m of data shard j's rows), the 'model' group where every rank
    holds every row (serving with no split, or rows that did not divide)."""
    if split is not None:
        rows = dist.get_world_size(split.group)
        if rows * dist.get_world_size(tpg) == dist.get_world_size():
            return None
        if rows != 1:
            raise ValueError(f"rows over {rows} ranks and 'model' over "
                             f"{dist.get_world_size(tpg)} do not make the world")
    return tpg


def _moe_tokens(p, flat, m: MoEConfig, group, ep, alone: bool = False):
    """The MoE on this rank's tokens `flat` (t, d), rank i of `group`
    (None: the world; `alone`: this rank only) holding tokens [i t,
    (i + 1) t) of the global order.  Returns (y (t, d), aux)."""
    n = 1 if alone else dist.get_world_size(group)
    t = flat.shape[0]
    gs = min(m.group_size, n * t)
    if t % gs == 0 or n == 1:  # this rank's groups are its own
        y, aux = _grouped(p, flat, gs, m, ep)
        aux = torch.mean(aux)
    else:  # a group spans ranks: cut the global groups from every rank's tokens
        total, rank = n * t, dist.get_rank(group)
        lo, hi = rank * t, (rank + 1) * t
        # the groups that hold this rank's rows, or, under expert parallelism,
        # any rows of its exchange's peers: every peer runs the same groups
        ranks = [rank] if ep is None else _peers(group, ep)
        first, last = min(ranks) * t // gs, ((max(ranks) + 1) * t - 1) // gs
        gathered = _GatherRows.apply(flat, group)
        y, aux_g = _grouped(p, gathered[first * gs:min((last + 1) * gs, total)], gs, m, ep)
        y = y[lo - first * gs:hi - first * gs]
        n_groups = -(-total // gs)
        weights = [max(0, min(hi, (g + 1) * gs) - max(lo, g * gs)) * n
                   / ((min(total, (g + 1) * gs) - g * gs) * n_groups)
                   for g in range(first, last + 1)]
        aux = sum(a * w for a, w in zip(aux_g, weights, strict=True))
    return y, aux

"""Tensor parallelism over the mesh's 'model' axis: the collectives GSPMD
inserts into the reference's partitioned products, as `torch.distributed`
calls over the 'model' group.

The reference shards every dense projection over 'model' (Megatron:
column-parallel projections keep their output columns local, row-parallel
ones their input rows, and the product is summed over 'model'), and the
embedding table and the unembedding their vocab.  GSPMD partitions the
products and inserts the collectives.  The port computes the same layout
explicitly: a block reads each tensor-parallel leaf with its 'model' shard
kept (`launch.shardings.shard_model` records which, `models.sharding`
gathers them so) and moves its activations between two kinds of
computation with four autograd functions over the 'model' group:
  - replicated: the same values on every 'model' peer (the rows lie over
    the batch axes only), and the same gradients;
  - per rank: each peer's heads, channels or vocab rows.
  copy   replicated -> per rank: identity forward, all-reduce backward (the
         peers' partial gradients of the replicated input summed);
  reduce per rank -> replicated: all-reduce forward (a row-parallel
         product's partial sums), identity backward;
  gather per rank -> replicated: all-gather along a dim forward, this
         rank's slice backward (the gradient is the same on every peer);
  cut    replicated -> per rank: this rank's slice forward, all-gather
         backward.
Each is the identity on a group of one.  A leaf read in a replicated
computation has its whole gradient on each peer (Replicate over 'model'),
a leaf read in a per-rank computation only this peer's part (Partial, or
its shard).

Divisibility decides a block's split, as the reference's guard drops an
axis that does not divide a dimension: a block splits its heads (or
channels, or vocab) only where they divide by the 'model' size, and
otherwise computes that part replicated from leaves gathered whole.
`launch.shardings` and the blocks take the split from the functions here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import sharding


def group():
    """The tensor-parallel group of the installed `sharding.activation_sharding`:
    its `TokenSplit`'s `tp`, or with no split (serving) the mesh's 'model'
    group where that axis has more than one rank; else None."""
    split = sharding.token_split()
    if split is not None:
        return split.tp
    mesh = sharding.current_mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return mesh.get_group("model")


def size() -> int:
    g = group()
    return 1 if g is None else dist.get_world_size(g)


def rank() -> int:
    g = group()
    return 0 if g is None else dist.get_rank(g)


def is_split(p, name: str) -> bool:
    """Whether the block's parameter group `p` (as `sharding.gathered`
    hands it over) holds leaf `name` with its 'model' shard kept."""
    return name in getattr(p, "split", ())


def _group_or_raise():
    g = group()
    if g is None:
        raise RuntimeError("a tensor-parallel leaf read outside a mesh with a 'model' axis "
                           "(models.sharding.activation_sharding)")
    return g


# --- the split rules ------------------------------------------------------------------


def divides(n: int, tp: int) -> bool:
    """A dimension of n splits over tp ranks (never over one)."""
    return tp > 1 and n % tp == 0


def kv_heads(hq: int, hkv: int, tp: int, rank_: int) -> list[int]:
    """The global KV heads a rank holds where its hq / tp query heads are
    split but the hkv KV heads are not: query head i reads KV head
    i // (hq / hkv).  Each KV head its heads read, once, where every KV head
    serves the same number of them (grouped-query attention of the local
    heads); else one KV head for each local query head, in order."""
    hq_l, group_ = hq // tp, hq // hkv
    heads = [i // group_ for i in range(rank_ * hq_l, (rank_ + 1) * hq_l)]
    if hq_l % group_ == 0 or group_ % hq_l == 0:
        return sorted(set(heads))
    return heads


# --- the collectives --------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_):
        ctx.group = group_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group_)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x, dim: int, group_):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group_))]
    dist.all_gather(parts, x.contiguous(), group=group_)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_):
        ctx.dim, ctx.n, ctx.rank = dim, dist.get_world_size(group_), dist.get_rank(group_)
        return _all_gather(x, dim, group_)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_):
        ctx.dim, ctx.group = dim, group_
        n, r = dist.get_world_size(group_), dist.get_rank(group_)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def copy(x):
    """Identity forward; the gradient all-reduced over 'model' backward."""
    return _Copy.apply(x, _group_or_raise())


def reduce(x):
    """x summed over 'model' forward (every peer the same bits); identity
    backward."""
    return _Reduce.apply(x, _group_or_raise())


def gather(x, dim: int):
    """Every peer's x concatenated along `dim` in rank order; backward, this
    rank's slice of the (replicated) gradient."""
    return _Gather.apply(x, dim % x.dim(), _group_or_raise())


def cut(x, dim: int):
    """This rank's slice of x along `dim` (which must divide); backward,
    every peer's gradient slice gathered."""
    return _Cut.apply(x, dim % x.dim(), _group_or_raise())

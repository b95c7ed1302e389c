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
computation with autograd functions over the 'model' group:
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

Sequence parallelism (the reference's `seq-parallel` rule, "act" sharding
the sequence over 'model'): between the blocks the residual stream is each
peer's slice of the sequence, and a block moves it in and out with two more
functions (`enter`, `leave`):
  gather_seq  the sequence gathered for a per-rank consumer (a
              column-parallel projection): all-gather forward,
              reduce-scatter backward;
  scatter_seq a row-parallel product's partial sums, summed and cut to this
              rank's slice: reduce-scatter forward, all-gather backward.
A block that computes replicated reads its input through `gather` and
writes its output through `cut` (its gradient is whole on every peer, so a
reduce-scatter would count it tp times), and a replicated leaf read on the
slice (a norm's scale) through `copy`, which sums its peers' parts of the
gradient (`on_shard`).  Whether the residual stream is a slice is the
sharding context's (`models.sharding.sequence`): the rule, and the
reference's divisibility guard on the sequence's length.

The vocab-parallel loss and greedy pick (`vocab_parallel_nll`,
`vocab_parallel_argmax`) read each rank's vocab slice of the logits and
combine over 'model' what the whole-vocab versions would compute, so the
logits are never gathered.

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


# --- sequence parallelism ------------------------------------------------------------------


def _reduce_scatter(x, dim: int, group_):
    """x summed over `group_`, this rank's slice along `dim`."""
    n = dist.get_world_size(group_)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group_)
    return out.movedim(0, dim)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_):
        ctx.dim, ctx.group = dim, group_
        return _all_gather(x, dim, group_)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_):
        ctx.dim, ctx.group = dim, group_
        return _reduce_scatter(x, dim, group_)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def gather_seq(x, dim: int):
    """Every peer's slice of the sequence concatenated along `dim` for a
    per-rank consumer; backward, the peers' gradients summed and cut to
    this rank's slice (a reduce-scatter)."""
    return _GatherSeq.apply(x, dim % x.dim(), _group_or_raise())


def scatter_seq(x, dim: int):
    """Partial sums x summed over 'model' and cut to this rank's slice along
    `dim` (a reduce-scatter); backward, the slices' gradients gathered."""
    return _ScatterSeq.apply(x, dim % x.dim(), _group_or_raise())


def shards_sequence(n: int) -> bool:
    """Whether the installed rules shard a sequence of n positions over
    'model' (the "act" rule names 'model' on the sequence, as under the
    reference's `seq-parallel`, and n divides by the 'model' size: the
    reference's guard keeps a sequence that does not divide whole)."""
    act = sharding.rules().get("act")
    return act is not None and len(act) > 1 and act[1] == "model" and divides(n, size())


def enter(x, split: bool):
    """A block's input as its computation reads it, from the residual
    stream: per rank where `split` (`copy`; on a sequence slice,
    `gather_seq`), else replicated (the stream itself; on a slice, the
    sequence gathered)."""
    if sharding.sequence_sharded():
        return gather_seq(x, 1) if split else gather(x, 1)
    return copy(x) if split else x


def leave(y, split: bool):
    """A block's output as the residual stream holds it: a row-parallel
    product's partial sums where `split` (`reduce`; on a sequence slice,
    `scatter_seq`), else a replicated value (itself; on a slice, `cut`)."""
    if sharding.sequence_sharded():
        return scatter_seq(y, 1) if split else cut(y, 1)
    return reduce(y) if split else y


def on_shard(t):
    """A replicated leaf read on the residual stream (a norm's scale): on a
    sequence slice each peer's gradient is its tokens' part, summed over
    'model' here (`copy`) so the leaf's gradient stays whole."""
    return copy(t) if sharding.sequence_sharded() else t


# --- the vocab-parallel loss and greedy pick ------------------------------------------------


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group_):
        n, r = logits.shape[-1], dist.get_rank(group_)
        m = logits.detach().amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group_)
        s = torch.exp(logits - m[..., None]).sum(-1)
        dist.all_reduce(s, group=group_)
        local = labels.clamp_min(0) - r * n
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        gold = torch.where(mine, torch.gather(logits, -1, local[..., None])[..., 0],
                           torch.zeros_like(m))
        dist.all_reduce(gold, group=group_)
        ctx.save_for_backward(logits, m, s, local, mine)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        logits, m, s, local, mine = ctx.saved_tensors
        p = torch.exp(logits - m[..., None]) / s[..., None]
        p = p.scatter_add(-1, local[..., None], -mine[..., None].to(p.dtype))
        return p * g[..., None], None, None


def vocab_parallel_nll(local_logits, labels):
    """The next-token NLL of each position, logsumexp(logits) - logits[label],
    from this rank's contiguous vocab slice of the float32 logits (..., V /
    tp) over the 'model' group: the max all-reduced (MAX), the sum of
    exp(l - max) and the gold logit (from the rank whose slice holds the
    label, zero elsewhere) all-reduced (SUM).  A label < 0 reads id 0, as
    `loss_fn` reads it before its mask.  Backward, softmax - onehot of the
    local slice, with no collective."""
    return _VocabNLL.apply(local_logits, labels.long(), _group_or_raise())


def vocab_parallel_argmax(local_logits):
    """The global id of each row's largest logit from this rank's
    contiguous vocab slice (..., V / tp): the local max and argmax, offset to
    global ids and gathered over 'model'; among equal maxima the lowest id
    wins, as `torch.argmax` of the gathered logits picks it."""
    g = _group_or_raise()
    n, r, peers = local_logits.shape[-1], dist.get_rank(g), dist.get_world_size(g)
    i = torch.argmax(local_logits, -1)
    v = torch.gather(local_logits, -1, i[..., None])[..., 0].contiguous()
    i = (i + r * n).contiguous()
    vs, ids = [torch.empty_like(v) for _ in range(peers)], [torch.empty_like(i) for _ in range(peers)]
    dist.all_gather(vs, v, group=g)
    dist.all_gather(ids, i, group=g)
    vs, ids = torch.stack(vs), torch.stack(ids)
    first = (vs == vs.amax(0)).to(torch.int8).argmax(0)   # the lowest rank among the maxima
    return torch.gather(ids, 0, first[None])[0]

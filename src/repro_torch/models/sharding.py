"""Activation-sharding hooks and the gather on use: the port of
`repro.models.sharding`.

The model code is mesh-agnostic; the launcher installs a rule table mapping
logical names -> spec (`launch.shardings.activation_rules`), the mesh and a
`TokenSplit`, and `shard(x, name)` reads them only when they are installed
(a no-op otherwise).

Why `shard` only checks: in the reference, `with_sharding_constraint` tells
GSPMD how to lay out a global array it partitions itself.  The port runs one
program per rank on its rows of the global batch (the rows lie over the
batch axes, as the reference's `batch_shardings` lays them; the 'model'
peers of a data shard hold the same rows), so an activation already is this
rank's part of the global one and there is nothing left to constrain:
`shard` checks that its leading dim is the rank's rows and returns it.
Where the reference shards a dim over 'model', the port splits the
computation instead (`models.tensor_parallel`): the dense projections' heads
and channels, and the vocab of the embedding and the unembedding, each
rank computing its shard.  Under the reference's `seq-parallel` rule ("act"
sharding the sequence over 'model') the block outputs are each peer's slice
of the sequence: `sequence` tells the blocks, and `tensor_parallel` moves
the slices in and out of them.  The logits stay vocab-parallel through the
loss and the greedy pick (`tensor_parallel.vocab_parallel_nll`, `_argmax`).

`gathered(pdict)` is the other half of the sharded layout
(`launch.shardings.shard_model`): a parameter held as a DTensor shard is
redistributed to its `gather_to` placements where the model reads it (its
'model' shard kept where the block splits over 'model', every other axis
gathered) and handed over as a plain tensor, so no DTensor reaches a kernel,
`layers.dot` or an `nn.functional` call; the dict says which leaves kept
their 'model' shard (`split`).  Its gradient comes back with the placements
`grad_to` names (partial over the batch axes, whose ranks hold distinct
rows; over 'model' its shard, whole where the read was replicated, partial
where each peer read its part), which the redistribute's backward reduces
into this rank's shard of the summed gradient.  `Block.__getitem__` and the
model's embedding, unembedding and final-norm reads call it, inside each
block's `torch.utils.checkpoint`, so full remat gathers again in the
backward and only one block's weights are whole at a time.

Caches alike, inside `activation_sharding(..., sharded_caches=True)` only
(the dry run's serving layout, `launch.dryrun`): a cache leaf held as a
DTensor shard is gathered where a block reads its cache (`gathered_cache`),
a leaf held otherwise than the block computes it is cut to the block's part
(`cut_cache`), the block reads and writes its part, and `keep_shards`
copies this rank's shard of the result back (`uncut_cache` first gathers a
cut leaf over 'model').  In decode, a leaf held as its sequence's 'model'
shard (`kv-seq-sharded` K/V, MLA's latent cache) is not gathered: the block
reads and writes this rank's slots in place, and attention combines the
peers' partial softmaxes (`models.attention`), as GSPMD's flash-decoding
combine does.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

# process-wide, not thread-local as the reference's: the backward's remat
# recompute reads it on the autograd engine's device thread
_CTX: list = [None]
_SEQ: list = [False]    # the residual stream is this rank's slice of the sequence


@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """How a step's global batch lies across ranks: rank i of `group` (None:
    the default group) holds rows [i rows, (i + 1) rows) of it.  `experts` is
    the group the MoE's expert stacks are sharded over ('model'), or None;
    `tp` the 'model' group whose peers hold the same rows and split the
    dense projections (tensor parallelism), or None."""

    rows: int
    group: object = None
    experts: object = None
    tp: object = None


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict, split: TokenSplit | None = None,
                        sharded_caches: bool = False):
    """rules: logical name -> spec; split: this step's `TokenSplit`;
    sharded_caches: the caches' leaves may be DTensor shards (the dry run's
    serving layout), which each block gathers (`gathered_cache`)."""
    prev = _CTX[0]
    _CTX[0] = (mesh, rules, split, sharded_caches)
    try:
        yield
    finally:
        _CTX[0] = prev


def current_mesh():
    ctx = _CTX[0]
    return None if ctx is None else ctx[0]


def token_split() -> TokenSplit | None:
    ctx = _CTX[0]
    return None if ctx is None else ctx[2]


def caches_sharded() -> bool:
    ctx = _CTX[0]
    return ctx is not None and ctx[3]


def rules() -> dict:
    ctx = _CTX[0]
    return {} if ctx is None else ctx[1]


@contextlib.contextmanager
def sequence(sharded: bool):
    """Within: the residual stream is (`sharded`) or is not this rank's slice
    of the sequence.  `models.model` sets it around each block (its remat
    recompute too) and the final norm and unembedding."""
    prev = _SEQ[0]
    _SEQ[0] = sharded
    try:
        yield
    finally:
        _SEQ[0] = prev


def sequence_sharded() -> bool:
    return _SEQ[0]


def shard(x, name: str):
    ctx = _CTX[0]
    if ctx is None:
        return x
    _, rules, split, _ = ctx
    if rules.get(name) is not None and split is not None and x.shape[0] != split.rows:
        raise ValueError(f"{name}: leading dim {x.shape[0]}, but this rank holds "
                         f"{split.rows} rows of the batch")
    return x


def gather(p):
    """A parameter as the model reads it: a DTensor redistributed to its
    `gather_to` placements, as a plain tensor whose gradient has the
    placements `grad_to`; any other tensor as it is."""
    if not isinstance(p, DTensor):
        return p
    if not torch.is_grad_enabled():
        # serving: no gradient to place, and DTensor's autograd functions
        # refuse inference tensors (`aten.detach_` has no sharding strategy)
        with torch.inference_mode(False), torch.no_grad():
            if tuple(p.placements) != tuple(p.gather_to):
                p = p.redistribute(p.device_mesh, p.gather_to)
            return p.to_local()
    return p.redistribute(p.device_mesh, p.gather_to).to_local(grad_placements=p.grad_to)


class Read(dict):
    """A parameter group as a block reads it; `split`: the names of the
    leaves that kept their 'model' shard (tensor parallelism)."""

    split: frozenset = frozenset()


def gathered(pdict: nn.ParameterDict):
    """`pdict` itself where its module is not sharded, else a `Read` of its
    parameters gathered (nested dicts alike)."""
    if not getattr(pdict, "sharded", False):
        return pdict
    out = Read({k: gathered(v) if isinstance(v, nn.ParameterDict) else gather(v)
                for k, v in pdict.items()})
    out.split = frozenset(k for k, v in pdict.items() if getattr(v, "tp_split", False))
    return out


def _any_shard(cache: dict) -> bool:
    return any(_any_shard(v) if isinstance(v, dict) else isinstance(v, DTensor)
               for v in cache.values())


def _sequence_shard(v: DTensor, dim: int):
    """(offset, whole length) of this rank's slots where `v` is held as its
    'model' shard along `dim` and whole over every other mesh dim, else
    None."""
    names = v.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    want = tuple(Shard(dim) if n == "model" else Replicate() for n in names)
    if tuple(v.placements) != want:
        return None
    rank, n = v.device_mesh.get_local_rank("model"), v.device_mesh.size(names.index("model"))
    return rank * (v.shape[dim] // n), v.shape[dim]


def gathered_cache(cache: dict | None, fresh: bool = False, seq_dims: dict | None = None):
    """(cache, local): `cache` itself where no leaf is a DTensor, else a copy
    whose DTensor leaves are whole plain tensors: gathered, or zeros of the
    whole shape where the block is about to fill the cache (`fresh`:
    prefill).  Not fresh, a leaf that `seq_dims` names ({"mix.k": its
    sequence dim}) and that is held as its 'model' shard along that dim is
    this rank's slots, the DTensor's own local tensor (a write lands in
    it); `local` names those leaves, and the copy gives each dict holding
    them `"shard": (offset, whole length)` of its slots."""
    local: set = set()
    if cache is None or not _any_shard(cache):
        return cache, local

    def whole(v, key=""):
        if isinstance(v, dict):
            out = {}
            for k, x in v.items():
                where = (_sequence_shard(x, seq_dims[f"{key}{k}"])
                         if isinstance(x, DTensor) and not fresh
                         and f"{key}{k}" in (seq_dims or {}) else None)
                if where is None:
                    out[k] = whole(x, f"{key}{k}.")
                else:
                    out[k], out["shard"] = x.to_local(), where
                    local.add(f"{key}{k}")
            return out
        if not isinstance(v, DTensor):
            return v
        if fresh:
            return v.to_local().new_zeros(v.shape)
        return v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim).to_local()

    return whole(cache), local


def keep_shards(held: dict, whole: dict, local: set = frozenset(), prefix: str = "") -> None:
    """Write back what a block did to the whole cache `whole`: into `held`'s
    DTensor leaves this rank's shard of each (a local cut, no
    communication), into its plain leaves their new values (the leaf keeps
    its storage; the 0-d `pos` is the same tensor on both sides, advanced in
    place by attention); the leaves `local` names were written in place, and
    the `"shard"` entries are dropped."""
    for k, v in whole.items():
        old = held.get(k)
        if k == "shard" or f"{prefix}{k}" in local:
            continue
        if isinstance(v, dict):
            keep_shards(old, v, local, f"{prefix}{k}.")
        elif isinstance(old, DTensor):
            part = v
            for i, pl in enumerate(old.placements):
                if isinstance(pl, Shard):
                    mesh = old.device_mesh
                    part = part.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
            old.to_local().copy_(part)
        elif isinstance(old, torch.Tensor) and old is not v:
            old.copy_(v)             # a plain leaf keeps its storage
        else:
            held[k] = v


def _leaf(cache: dict, key: str):
    node = cache
    for k in key.split("."):
        node = node[k]
    return node


def _set_leaf(cache: dict, key: str, value) -> None:
    *path, last = key.split(".")
    node = cache
    for k in path:
        node = node[k]
    node[last] = value


def cut_cache(cache: dict, cuts: dict, rank: int) -> tuple[dict, dict]:
    """`cache` (whole leaves, or already the block's parts) with each leaf
    that `cuts` names ({"mix.k": (dim, [indices along dim of the whole leaf
    that 'model' rank r computes, for each r])}) cut to rank `rank`'s part
    where it is still whole.  Returns (the cache, the cuts applied)."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in cache.items()}
    done = {}
    for key, (dim, per_rank) in cuts.items():
        leaf, idx = _leaf(out, key), per_rank[rank]
        whole = 1 + max(j for part in per_rank for j in part)
        # whole, and not already this rank's part (an uneven part, such as
        # KV heads [0, 0, 1] of 3, is never held: it is cut here)
        if leaf.shape[dim] == whole and idx != list(range(whole)):
            _set_leaf(out, key, leaf.index_select(
                dim, torch.tensor(idx, device=leaf.device)))
            done[key] = (dim, per_rank, whole)
    return out, done


def uncut_cache(cache: dict, done: dict, group) -> dict:
    """The inverse of `cut_cache` for the leaves it cut: every 'model'
    peer's part gathered over `group`, and of each whole index the first
    peer's copy."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in cache.items()}
    for key, (dim, per_rank, whole) in done.items():
        part = _leaf(out, key).contiguous()
        parts = [torch.empty_like(part) for _ in per_rank]
        dist.all_gather(parts, part, group=group)
        first = {}
        for i, j in enumerate(j for idx in per_rank for j in idx):
            first.setdefault(j, i)
        pick = torch.tensor([first[j] for j in range(whole)], device=part.device)
        _set_leaf(out, key, torch.cat(parts, dim=dim).index_select(dim, pick))
    return out

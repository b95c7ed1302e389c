"""Activation-sharding hooks and the gather on use: the port of
`repro.models.sharding`.

The model code is mesh-agnostic; the launcher installs a rule table mapping
logical names -> spec (`launch.shardings.activation_rules`) and a
`TokenSplit`, and `shard(x, name)` reads them only when they are installed
(a no-op otherwise).

Why `shard` only checks: in the reference, `with_sharding_constraint` tells
GSPMD how to lay out a global array it partitions itself.  The port runs one
program per rank on its own rows of the global batch (the ranks of the
split in rank order, each `rows` rows), so an activation already is this
rank's shard of the global one and there is nothing left to constrain:
`shard` checks that its leading dim is the rank's rows and returns it.  The
dims the reference would shard over 'model' (sequence parallelism, the
logits' vocab) stay whole: the port gathers weights, it does not split the
dense projections across ranks.

`gathered(pdict)` is the other half of the sharded layout
(`launch.shardings.shard_model`): a parameter held as a DTensor shard is
redistributed to its `gather_to` placements where the model reads it and
handed over as a plain tensor, so no DTensor reaches a kernel, `layers.dot`
or an `nn.functional` call.  Its gradient comes back as a partial sum over
the mesh dims the read replicated, which the redistribute's backward reduces
into this rank's shard of the summed gradient.  `Block.__getitem__` and the
model's embedding, unembedding and final-norm reads call it, inside each
block's `torch.utils.checkpoint`, so full remat gathers again in the
backward and only one block's weights are whole at a time.

Caches alike, inside `activation_sharding(..., sharded_caches=True)` only
(the dry run's serving layout, `launch.dryrun`): a cache leaf held as a
DTensor shard (its head, latent or sequence dim over 'model') is gathered
where a block reads its cache (`gathered_cache`), the block reads and writes
the whole, and `keep_shards` copies this rank's shard of the result back.
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# process-wide, not thread-local as the reference's: the backward's remat
# recompute reads it on the autograd engine's device thread
_CTX: list = [None]


@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """How a step's global batch lies across ranks: rank i of `group` (None:
    the default group) holds rows [i rows, (i + 1) rows) of it.  `experts` is
    the group the MoE's expert stacks are sharded over ('model'), or None."""

    rows: int
    group: object = None
    experts: object = None


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


def token_split() -> TokenSplit | None:
    ctx = _CTX[0]
    return None if ctx is None else ctx[2]


def caches_sharded() -> bool:
    ctx = _CTX[0]
    return ctx is not None and ctx[3]


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
    `gather_to` placements, as a plain tensor whose gradient is partial over
    the mesh dims it replicates; any other tensor as it is."""
    if not isinstance(p, DTensor):
        return p
    grad = [Partial() if isinstance(t, Replicate) else t for t in p.gather_to]
    return p.redistribute(p.device_mesh, p.gather_to).to_local(grad_placements=grad)


def gathered(pdict: nn.ParameterDict):
    """`pdict` itself where its module is not sharded, else a dict of its
    parameters gathered (nested dicts alike)."""
    if not getattr(pdict, "sharded", False):
        return pdict
    return {k: gathered(v) if isinstance(v, nn.ParameterDict) else gather(v)
            for k, v in pdict.items()}


def _any_shard(cache: dict) -> bool:
    return any(_any_shard(v) if isinstance(v, dict) else isinstance(v, DTensor)
               for v in cache.values())


def gathered_cache(cache: dict | None, fresh: bool = False):
    """`cache` itself where no leaf is a DTensor, else a copy whose DTensor
    leaves are whole plain tensors: gathered, or zeros of the whole shape
    where the block is about to fill the cache (`fresh`: prefill)."""
    if cache is None or not _any_shard(cache):
        return cache

    def whole(v):
        if isinstance(v, dict):
            return {k: whole(x) for k, x in v.items()}
        if not isinstance(v, DTensor):
            return v
        if fresh:
            return v.to_local().new_zeros(v.shape)
        return v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim).to_local()

    return whole(cache)


def keep_shards(held: dict, whole: dict) -> None:
    """Write back what a block did to the whole cache `whole`: into `held`'s
    DTensor leaves this rank's shard of each (a local cut, no
    communication), every other entry as it is."""
    for k, v in whole.items():
        old = held.get(k)
        if isinstance(v, dict):
            keep_shards(old, v)
        elif isinstance(old, DTensor):
            local = v
            for i, pl in enumerate(old.placements):
                if isinstance(pl, Shard):
                    mesh = old.device_mesh
                    local = local.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
            old.to_local().copy_(local)
        else:
            held[k] = v

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
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

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
def activation_sharding(mesh, rules: dict, split: TokenSplit | None = None):
    """rules: logical name -> spec; split: this step's `TokenSplit`."""
    prev = _CTX[0]
    _CTX[0] = (mesh, rules, split)
    try:
        yield
    finally:
        _CTX[0] = prev


def token_split() -> TokenSplit | None:
    ctx = _CTX[0]
    return None if ctx is None else ctx[2]


def shard(x, name: str):
    ctx = _CTX[0]
    if ctx is None:
        return x
    _, rules, split = ctx
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

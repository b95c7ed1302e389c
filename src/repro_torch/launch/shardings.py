"""Parameter / activation / cache sharding rules, and the sharded parameter
layout of the port.

The rule table is `repro.launch.shardings`' (DESIGN.md S5), copied as it is:
  - TP (Megatron): column-parallel projections shard their output dim over
    'model'; row-parallel (output-side) projections shard their input dim
    over 'model'.
  - FSDP/ZeRO: the *other* weight dim shards over 'data' (params + optimizer
    moments), gathered on use.
  - EP: expert-indexed weights (E, ...) shard E over 'model'.
  - 'pod' is pure DP for parameters (replicated; gradients all-reduce across
    pods); activations/caches shard their batch dim over ('pod','data').
Every rule is divisibility-guarded: an axis that doesn't divide the dim is
dropped (replicated) rather than mis-sharded, so one rule table serves every
architecture.

A spec is the reference's `PartitionSpec` as a tuple, one entry per *tensor*
dimension: None, an axis name, or a tuple of axis names.  `placements` turns
it into DTensor placements, one per *mesh* dimension (`Shard(d)` where the
mesh axis shards tensor dim d, else `Replicate()`), and `spec_of` turns them
back.  The rules take a `DeviceMesh` or any object with `axis_names` and a
`shape` mapping (`mesh.axis_sizes`).

The port's blocks are one module per layer, not scan-stacked (`interop`), so
a block leaf takes the reference's stacked spec with its leading None
dropped.  `shard_model` (port-only) is the sharded layout of the training
path: each parameter becomes a DTensor holding this rank's shard, and
`models.sharding` gathers it where a block reads it (on use, inside the
block's remat), its gradient coming back as this rank's shard of the sum.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from .mesh import axis_sizes, batch_axes

# weight-name -> (spec for last dims); leading stack/rep dims padded with None
_ROW_PARALLEL = {"wo", "w_down", "w_out", "w_v", "w_o"}  # input dim over model
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_a", "w_x",
                 "w_r", "w_k", "w_g", "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv"}
_EXPERT_WEIGHTS = {"w_gate", "w_up", "w_down"}


def _axis_fits(mesh, axis, dim) -> bool:
    sizes = axis_sizes(mesh)
    return axis in sizes and dim % sizes[axis] == 0


def _leaf_spec(mesh, path_keys: list[str], shape: tuple[int, ...],
               moe_expert_axis: str = "model") -> tuple:
    name = path_keys[-1]
    in_block = any(k in ("decoder", "encoder") for k in path_keys)
    nd = len(shape)
    lead = 1 if in_block else 0      # scan-stacked rep dim
    core = shape[lead:]

    def guard(spec_core):
        fixed = []
        for dim, ax in zip(core, spec_core, strict=False):
            fixed.append(ax if ax is not None and _axis_fits(mesh, ax, dim)
                         else None)
        return tuple([None] * lead + fixed)

    if name == "table":              # embedding (V, d): vocab over model
        return guard(["model", "data"])
    if name == "w" and len(core) == 2 and not in_block:  # unembed (d, V)
        return guard(["data", "model"])
    # MoE expert stacks (E, d, ff) / (E, ff, d)
    if name in _EXPERT_WEIGHTS and len(core) == 3:
        if moe_expert_axis == "data":
            # EP over 'data' + TP-within-expert over 'model': weights are
            # fully sharded -> zero FSDP all-gathers; tokens all-to-all over
            # 'data' (the Perf hillclimb variant, EXPERIMENTS.md #Perf)
            if name == "w_down":               # (E, ff, d)
                return guard(["data", "model", None])
            return guard(["data", None, "model"])  # (E, d, ff)
        return guard(["model", "data", None])
    if name == "router":
        return guard(["data", None])
    if len(core) == 2 and name in _ROW_PARALLEL:
        return guard(["model", "data"])
    if len(core) == 2 and (name in _COL_PARALLEL or name == "w"):
        return guard(["data", "model"])
    return tuple([None] * nd)        # norms, biases, scalars: replicate


def _param_keys(name: str) -> tuple[list[str], bool]:
    """(the reference's path keys, in a block?) of a `Model` parameter name:
    `blocks.3.mix.wq` is a leaf of the reference's "decoder" segments."""
    keys = name.split(".")
    in_block = keys[0] in ("blocks", "encoder")
    return (["decoder", *keys[1:]] if keys[0] == "blocks" else keys), in_block


def param_shardings(mesh, model: nn.Module, moe_expert_axis: str = "model",
                    fsdp: bool = True) -> dict[str, tuple]:
    """{parameter name: spec} of a `Model`, in `named_parameters` order.

    fsdp=False drops the 'data' axis from every weight spec (TP-only):
    the serving layout — no optimizer state to shard, and per-step weight
    all-gathers disappear (weights are resident once loaded)."""
    out = {}
    for name, p in model.named_parameters():
        keys, in_block = _param_keys(name)
        shape = tuple(p.shape)
        spec = (_leaf_spec(mesh, keys, (1, *shape), moe_expert_axis)[1:] if in_block
                else _leaf_spec(mesh, keys, shape, moe_expert_axis))
        if not fsdp:
            spec = tuple(None if ax == "data" else ax for ax in spec)
        out[name] = spec
    return out


def _entry(axes: tuple):
    """A spec entry of several axes as `PartitionSpec` normalises it: none is
    None, one is its name."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def batch_shardings(mesh, batch_shapes: dict) -> dict:
    """Input batch: leading (global-batch) dim over ('pod','data').  Takes a
    dict of shapes (or of arrays), returns a dict of specs."""
    baxes = batch_axes(mesh)

    def one(shape):
        shape = tuple(getattr(shape, "shape", shape))
        spec = [_entry(baxes) if shape and shape[0] % _prod(mesh, baxes) == 0
                else None] + [None] * (len(shape) - 1)
        return tuple(spec)

    return {k: one(v) for k, v in batch_shapes.items()}


def _prod(mesh, axes):
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def cache_shardings(mesh, cache_shapes: dict, kv_seq_shard: bool = False) -> dict:
    """KV caches / recurrent states: batch over ('pod','data'); head or
    feature dims over 'model' when divisible.  Takes {key: shape} of the
    reference's scan-stacked cache leaves, (reps, B, ...), and returns
    {key: spec}: a pure function (sharded serving is not ported).

    Heuristic: dim 1 = batch; for >=4D leaves shard dim 2 (heads / latent)
    over 'model' when divisible.

    kv_seq_shard: when the head dim does NOT divide the model axis (GQA with
    few KV heads), shard the *sequence* dim (3) over 'model' instead —
    flash-decoding style: each model shard attends over its slice and GSPMD
    inserts the partial-softmax combine.
    """
    baxes = batch_axes(mesh)

    def one(shape):
        shape = tuple(getattr(shape, "shape", shape))
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2 and shape[1] % _prod(mesh, baxes) == 0:
            spec[1] = _entry(baxes)
        if nd >= 4 and _axis_fits(mesh, "model", shape[2]):
            spec[2] = "model"
        elif (kv_seq_shard and nd >= 5
              and _axis_fits(mesh, "model", shape[3])):
            spec[3] = "model"  # (reps, B, H, S, hd): shard S
        return tuple(spec)

    return {k: one(v) for k, v in cache_shapes.items()}


def activation_rules(mesh, seq_parallel: bool = False) -> dict:
    """Rules consumed by models.sharding.shard().

    seq_parallel: shard the sequence dim of block outputs over 'model'
    (Megatron sequence parallelism)."""
    baxes = batch_axes(mesh)
    model = "model" if "model" in axis_sizes(mesh) else None
    return {
        "act": (_entry(baxes), model if seq_parallel else None, None),
        "logits": (_entry(baxes), None, model),
    }


# --- specs and placements -------------------------------------------------------------


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of `spec` on `mesh`: for each mesh dimension,
    Shard(d) where tensor dim d's entry names that axis (alone or in a tuple,
    whose order is the sharding's major-to-minor order, as the mesh's), else
    Replicate().  The embedding's ("model", "data") on (V, d) over a
    ("data", "model") mesh is (Shard(1), Shard(0))."""
    owner = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax in owner:
                raise ValueError(f"spec {spec} names axis {ax!r} twice")
            owner[ax] = d
    names = list(axis_sizes(mesh))
    unknown = set(owner) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names {sorted(unknown)}, not axes of {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def spec_of(mesh, placements_: tuple, ndim: int) -> tuple:
    """The inverse of `placements`: one entry per tensor dim, the mesh axes
    that shard it in mesh order (one name, or a tuple of several)."""
    axes: list[list[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(axis_sizes(mesh), placements_, strict=True):
        if isinstance(pl, Shard):
            axes[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is neither Shard nor Replicate")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


def local_shard(t: torch.Tensor, mesh, placements_: tuple) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` under `placements_`, as a
    contiguous copy (the whole tensor can be freed): mesh dimensions in
    order, each Shard(d) cutting dim d into the mesh dimension's size."""
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return t.contiguous().clone()


def distribute(t: torch.Tensor, mesh, placements_: tuple) -> DTensor:
    """`t` (the whole tensor, the same on every rank) as a DTensor holding
    this rank's shard; no communication."""
    return DTensor.from_local(local_shard(t, mesh, placements_), mesh, placements_,
                              run_check=False)


def _gather_to(name: str, ndim: int, pl: tuple) -> tuple:
    """What a read gathers a parameter to: everything whole, but the expert
    stacks (E, ., .) keep E sharded over the axis that shards it, 'model' by
    default, 'data' under `moe_expert_axis="data"` (expert parallelism: each
    rank runs its own experts on every peer's slots)."""
    keep = name.split(".")[-1] in _EXPERT_WEIGHTS and ndim == 3
    return tuple(p if keep and isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl)


def shard_model(model: nn.Module, mesh, moe_expert_axis: str = "model",
                fsdp: bool = True) -> dict[str, tuple]:
    """Turn every parameter of `model` (whole, the same on every rank) into a
    DTensor parameter holding this rank's shard under the rule table
    (`param_shardings`' options), in place; the whole tensors are freed.
    Each parameter is gathered where the model reads it
    (`models.sharding.gathered`) to `p.gather_to`.  Returns {name:
    placements}."""
    specs = param_shardings(mesh, model, moe_expert_axis, fsdp)
    out = {}
    for name, spec in specs.items():
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        pl = placements(mesh, spec)
        with torch.no_grad():
            param = nn.Parameter(distribute(getattr(owner, leaf).detach(), mesh, pl))
        param.gather_to = _gather_to(name, param.dim(), pl)
        owner[leaf] = param
        out[name] = pl
    for module in model.modules():
        module.sharded = True
    return out

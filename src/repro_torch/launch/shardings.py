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
and serving paths: each parameter becomes a DTensor holding this rank's
shard (storage: the rule table's), and `models.sharding` gathers it where a
block reads it (on use, inside the block's remat) to its compute layout:
the tensor-parallel leaves keep their 'model' shard (`tp_role`: the
reference's column- and row-parallel projections and vocab shards, where the
block's heads, channels or vocab divide by the 'model' size), every other
axis is gathered (FSDP), and the expert stacks keep E sharded (and, under
`moe_expert_axis="data"`, their d_ff over 'model': tensor parallelism inside
each expert); the gradient comes back as this rank's shard of the sum.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.tensor_parallel import divides

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


def leaf_spec(mesh, name: str, shape: tuple, moe_expert_axis: str = "model",
              fsdp: bool = True) -> tuple:
    """The spec of the `Model` parameter `name` of (whole) `shape`."""
    keys, in_block = _param_keys(name)
    shape = tuple(shape)
    spec = (_leaf_spec(mesh, keys, (1, *shape), moe_expert_axis)[1:] if in_block
            else _leaf_spec(mesh, keys, shape, moe_expert_axis))
    if not fsdp:
        spec = tuple(None if ax == "data" else ax for ax in spec)
    return spec


def param_shardings(mesh, model: nn.Module, moe_expert_axis: str = "model",
                    fsdp: bool = True) -> dict[str, tuple]:
    """{parameter name: spec} of a `Model`, in `named_parameters` order.

    fsdp=False drops the 'data' axis from every weight spec (TP-only):
    the serving layout — no optimizer state to shard, and per-step weight
    all-gathers disappear (weights are resident once loaded)."""
    return {name: leaf_spec(mesh, name, p.shape, moe_expert_axis, fsdp)
            for name, p in model.named_parameters()}


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


# --- the compute layout: what a read gathers to ------------------------------------------


def _mlp_role(name: str, d_ff: int, tp: int):
    if not divides(d_ff, tp):
        return "whole"
    return {"w_gate": ("shard", 1), "w_up": ("shard", 1), "w_in": ("shard", 1),
            "w_down": ("shard", 0), "w_out": ("shard", 0), "b_in": "part"}.get(name, "whole")


def _mix_role(name: str, kind: str, cfg, tp: int):
    """The tensor-parallel role of a mixer leaf (`models.tensor_parallel`):
    ("shard", dim) kept over 'model'; "whole" read in a replicated
    computation; "part" gathered whole and read in a per-rank one."""
    if kind in ("attn", "local"):
        if not divides(cfg.num_heads, tp):
            return "whole"
        if name in ("wk", "wv"):
            return ("shard", 1) if divides(cfg.num_kv_heads, tp) else "part"
        return {"wq": ("shard", 1), "wo": ("shard", 0)}[name]
    if kind == "mla":
        if not divides(cfg.num_heads, tp):
            return "whole"
        return {"w_uq": ("shard", 1), "w_uk": ("shard", 1), "w_uv": ("shard", 1),
                "wo": ("shard", 0)}.get(name, "whole")      # w_dq, w_dkv feed every head
    if kind == "rglru":
        if not divides(cfg.rglru_width or cfg.d_model, tp):
            return "whole"
        return {"w_gate": ("shard", 1), "w_in": ("shard", 1), "w_a": ("shard", 1),
                "w_x": ("shard", 1), "w_out": ("shard", 0)}.get(name, "part")
    if kind == "rwkv6":
        if not divides(cfg.d_model // cfg.rwkv_head_dim, tp):
            return "whole"
        # w_v is stored row-parallel (the rule table's `_ROW_PARALLEL`) but feeds the heads
        return {"w_r": ("shard", 1), "w_k": ("shard", 1), "w_v": ("shard", 1),
                "w_g": ("shard", 1), "w_o": ("shard", 0)}.get(name, "part")
    raise ValueError(kind)


def tp_role(name: str, cfg, kinds, tp: int, moe_expert_axis: str = "model"):
    """The tensor-parallel role of the `Model` parameter `name` on a 'model'
    axis of tp ranks, from the arch config (`kinds`: each decoder layer's
    block kind): divisibility decides it, as the reference's guard does."""
    keys = name.split(".")
    if keys[0] in ("embed", "unembed"):   # vocab-parallel
        return ("shard", 0 if keys[-1] == "table" else 1) \
            if divides(cfg.vocab_size, tp) else "whole"
    if keys[0] not in ("blocks", "encoder") or keys[2].startswith("norm"):
        return "whole"                     # final norm, patch projection, norms
    leaf = keys[-1]
    if keys[2] in ("mix", "cross"):
        kind = "attn" if keys[0] == "encoder" or keys[2] == "cross" else kinds[int(keys[1])]
        return _mix_role(leaf, kind, cfg, tp)
    if keys[0] == "blocks" and kinds[int(keys[1])] == "rwkv6":   # the RWKV channel mix
        if not divides(cfg.d_ff, tp):
            return "whole"
        return {"w_k": ("shard", 1), "w_v": ("shard", 0)}.get(leaf, "whole")
    if cfg.ffn == "moe" and keys[0] == "blocks":
        if keys[3] == "dense":             # Arctic's dense residual
            return _mlp_role(leaf, cfg.moe.dense_residual_d_ff, tp)
        if leaf == "router":               # read on the tokens cut over 'model'
            cut = moe_expert_axis == "model" and divides(cfg.moe.num_experts, tp)
            return "part" if cut else "whole"
        if moe_expert_axis == "data" and divides(cfg.moe.d_ff_expert, tp):
            # d_ff over 'model' inside each expert: (E, d, ff) and (E, ff, d)
            return ("expert", 1 if leaf == "w_down" else 2)
        return "expert"
    return _mlp_role(leaf, cfg.d_ff, tp)


def compute_layout(mesh, pl: tuple, role) -> tuple[tuple, tuple]:
    """(gather_to, grad_to) of a parameter stored with placements `pl`: the
    batch axes gathered, the gradient partial over them (their ranks hold
    distinct rows); over 'model' the role's shard kept, or the leaf
    gathered with its gradient whole ("whole") or partial ("part").  An
    expert stack ("expert", or ("expert", d) with its d_ff dim d kept over
    'model') keeps E (dim 0) sharded over whichever axis shards it."""
    expert = role == "expert" or (isinstance(role, tuple) and role[0] == "expert")
    gather_to, grad_to = [], []
    for ax, p in zip(axis_sizes(mesh), pl, strict=True):
        if expert and isinstance(p, Shard) and p.dim == 0:
            gather_to.append(p)
            grad_to.append(p)
        elif ax != "model":
            gather_to.append(Replicate())
            grad_to.append(Partial())
        elif isinstance(role, tuple):
            gather_to.append(Shard(role[1]))
            grad_to.append(Shard(role[1]))
        else:
            gather_to.append(Replicate())
            grad_to.append(Partial() if role == "part" else Replicate())
    return tuple(gather_to), tuple(grad_to)


def _install(model: nn.Module, name: str, local: torch.Tensor, mesh, pl: tuple,
             role) -> None:
    """Make `local` (this rank's shard under `pl`) the parameter `name` of
    `model`, a DTensor with its compute layout."""
    *path, leaf = name.split(".")
    owner = model.get_submodule(".".join(path))
    param = nn.Parameter(DTensor.from_local(local, mesh, pl, run_check=False))
    param.gather_to, param.grad_to = compute_layout(mesh, pl, role)
    param.tp_split = isinstance(role, tuple)
    owner[leaf] = param


def _mark_sharded(model: nn.Module) -> None:
    for module in model.modules():
        module.sharded = True


def _install_all(model: nn.Module, mesh, pls: dict[str, tuple], moe_expert_axis: str,
                 whole: bool) -> None:
    """Make every parameter of `model` a DTensor holding this rank's shard
    under its placements in `pls`, with its compute layout; `whole`: the
    parameters are whole and are cut here, else they are the shards."""
    tp = axis_sizes(mesh).get("model", 1)
    kinds = [b.kind for b in model.blocks]
    for name, pl in pls.items():
        local = model.get_parameter(name).detach()
        if whole:
            with torch.no_grad():
                local = local_shard(local, mesh, pl)
        _install(model, name, local, mesh, pl,
                 tp_role(name, model.cfg, kinds, tp, moe_expert_axis))
    _mark_sharded(model)


def shard_model(model: nn.Module, mesh, moe_expert_axis: str = "model",
                fsdp: bool = True) -> dict[str, tuple]:
    """Turn every parameter of `model` (a `models.Model`, whole, the same on
    every rank) into a DTensor parameter holding this rank's shard under the
    rule table (`param_shardings`' options), in place; the whole tensors are
    freed.  Each parameter is gathered where the model reads it
    (`models.sharding.gathered`) to its compute layout (`tp_role`,
    `compute_layout`): `p.gather_to`, its gradient's `p.grad_to`, and
    `p.tp_split` where it keeps a 'model' shard.  Returns {name:
    placements}."""
    pls = {name: placements(mesh, spec)
           for name, spec in param_shardings(mesh, model, moe_expert_axis, fsdp).items()}
    _install_all(model, mesh, pls, moe_expert_axis, whole=True)
    return pls


def init_sharded(cfg, generator: torch.Generator, device, mesh, fsdp: bool = True):
    """`models.init_params` drawn straight into the layout `shard_model(...,
    fsdp=fsdp)` gives the unsharded model: every leaf is drawn whole in the
    same order, this rank keeps its shard and the whole is freed as soon as
    its group (the embedding, a block) is cut, so the weights are bit for bit
    those of the unsharded model at the same seed while a rank holds one
    whole group at a time."""
    from repro_torch.models import init_params

    pls: dict[str, tuple] = {}

    def keep(prefix: str, group: dict) -> dict:
        out = {}
        for k in list(group):
            name, whole = f"{prefix}.{k}", group.pop(k)
            if isinstance(whole, dict):
                out[k] = keep(name, whole)
                continue
            pls[name] = placements(mesh, leaf_spec(mesh, name, whole.shape, fsdp=fsdp))
            out[k] = local_shard(whole, mesh, pls[name])
            del whole
        return out

    model = init_params(cfg, generator, device, keep)
    _install_all(model, mesh, {name: pls[name] for name, _ in model.named_parameters()},
                 "model", whole=False)
    return model

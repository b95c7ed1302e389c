"""Parameters between the JAX package's tree layout and the port (no JAX here).

`params_from_jax` takes the JAX parameter pytree already converted to numpy
arrays (`jax.tree.map(np.asarray, params)`, done by the caller) and returns
the port's `Model` with identical weights.  `tree_from_model` is its inverse:
the port's parameters, or their gradients, as numpy arrays in the JAX tree
layout, so the two can be compared leaf by leaf.  `tree_from_tensors` puts
any per-parameter tensors (the AdamW moments too) in that layout, keeping
their dtype, and `tensors_from_tree` takes them back out: the training
checkpoint is written in the reference's train-state layout so.  The JAX
tree stacks each segment's per-period blocks on a leading reps axis; the scan runs
`for rep in range(reps): for pos in period`, so that is the layer order here.
Projections keep the JAX `(d_in, d_out)` layout: the port computes `x @ w`.
A block's parameter dicts may nest (a MoE FFN's stacked `(E, ...)` experts
beside Arctic's dense residual under `ffn["dense"]`); both directions walk
any depth of dicts.  Whisper's `encoder` is one segment of
`num_encoder_layers` reps of an "attn" block, and internvl2's `patch_proj` a
top-level group beside the embeddings.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.config import ArchConfig
from .models.model import Model, segments


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _leaves(tree: dict, device, rep: int | None = None) -> dict:
    """The dicts of `tree` with each array as a tensor: one block (its rep-th
    slice) or the top-level groups."""
    return {k: _leaves(a, device, rep) if isinstance(a, dict) else
            _tensor(a if rep is None else np.asarray(a)[rep], device)
            for k, a in tree.items()}


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device: str | torch.device | None = None) -> Model:
    """tree: JAX `init_params` output as numpy arrays.  Returns a `Model`."""
    dev = resolve_device(device)
    top = _leaves({k: tree[k] for k in ("embed", "unembed", "final_norm", "patch_proj")
                   if k in tree}, dev)
    blocks = []
    for si, (kinds, reps) in enumerate(segments(cfg)):
        per_pos = tree["decoder"][si]
        for rep in range(reps):
            for pos in range(len(kinds)):
                blocks.append(_leaves(per_pos[pos], dev, rep))
    encoder = ([_leaves(tree["encoder"][0][0], dev, rep)
                for rep in range(cfg.num_encoder_layers)] if "encoder" in tree else [])
    return Model(cfg, top["embed"], top.get("unembed"), top["final_norm"], blocks,
                 encoder, top.get("patch_proj"))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _layout(model: Model, leaf, stack) -> dict:
    """The JAX tree layout of `model`'s parameters, each leaf `leaf(name, p)`,
    each segment's per-period blocks stacked leaf by leaf with `stack`."""

    def leaves(pdict) -> dict:
        out = {}
        for k, p in pdict.items():
            if isinstance(p, torch.nn.ParameterDict):  # a nested dict
                out[k] = leaves(p)
                continue
            out[k] = leaf(k, p)
        return out

    def stack_reps(trees: list) -> dict:
        """The per-rep dicts of one period position, stacked leaf by leaf."""
        return {k: stack_reps([t[k] for t in trees]) if isinstance(v, dict) else
                stack([t[k] for t in trees]) for k, v in trees[0].items()}

    def block_tree(block) -> dict:  # the parameters themselves, never gathered copies
        return {name: leaves(sub) for name, sub in block.named_children()}

    cfg = model.cfg
    tree = {"embed": leaves(model.embed)}
    if model.unembed is not None:
        tree["unembed"] = leaves(model.unembed)
    tree["final_norm"] = leaves(model.final_norm)
    decoder, layer = [], 0
    for kinds, reps in segments(cfg):
        per_pos = [[] for _ in kinds]
        for _rep in range(reps):
            for pos in range(len(kinds)):
                per_pos[pos].append(block_tree(model.blocks[layer]))
                layer += 1
        decoder.append([stack_reps(reps_list) for reps_list in per_pos])
    tree["decoder"] = decoder
    if len(model.encoder):
        tree["encoder"] = [[stack_reps([block_tree(b) for b in model.encoder])]]
    if model.patch_proj is not None:
        tree["patch_proj"] = leaves(model.patch_proj)
    return tree


def tree_from_model(model: Model, attr: str = "data") -> dict:
    """The JAX tree layout of `model`'s parameters (attr="data") or of their
    gradients (attr="grad") as numpy arrays; bf16 comes back as float32.

    Each segment's per-period blocks are stacked on a leading reps axis, with
    the same key names as `repro.models.init_params`."""
    if attr not in ("data", "grad"):
        raise ValueError(f"attr must be 'data' or 'grad', got {attr!r}")

    def leaf(k, p):
        t = getattr(p, attr)
        if t is None:
            raise ValueError(f"parameter {k!r} has no {attr}")
        return _numpy(t)

    return _layout(model, leaf, np.stack)


def tree_from_tensors(model: Model, tensors) -> dict:
    """`tensors`, one per parameter in `model.parameters()` order (the
    parameters themselves, or AdamW's moments), in the JAX tree layout: each
    segment's blocks stacked with `torch.stack`, dtype and device kept.  The
    training checkpoint writes its state so."""
    index = {id(p): i for i, p in enumerate(model.parameters())}

    def stack(ts):
        if ts[0].is_meta:  # a template's shapes: torch.stack would load the meta kernels
            return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype, device="meta")
        return torch.stack(ts)

    return _layout(model, lambda _, p: tensors[index[id(p)]], stack)


def leaf_parameters(model: Model) -> dict:
    """{keystr: what the leaf holds} for every leaf of `model`'s JAX tree
    layout, each path written as `jax.tree_util.keystr` writes it (as the
    checkpoint keys its arrays): a parameter, or the list of parameters that
    a stacked leaf holds (one per block of its segment)."""
    out = {}

    def walk(slot, key: str):
        if isinstance(slot, dict):
            for k, v in slot.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(slot, torch.Tensor) or isinstance(slot[0], torch.Tensor):
            out[key] = slot
        else:
            for i, v in enumerate(slot):
                walk(v, f"{key}[{i}]")

    walk(_layout(model, lambda _, p: p, list), "")
    return out


def tensors_from_tree(model: Model, tree: dict) -> list:
    """Inverse of `tree_from_tensors`: the leaves of a JAX-layout tree, one
    per parameter in `model.parameters()` order (a stacked leaf's slice for
    each block of a segment)."""
    slots = _layout(model, lambda _, p: p, list)  # a parameter, or one per rep
    found = {}

    def walk(slot, value):
        if isinstance(slot, dict):
            for k, v in slot.items():
                walk(v, value[k])
        elif isinstance(slot, torch.Tensor):
            found[id(slot)] = value
        elif slot and isinstance(slot[0], torch.Tensor):  # a stacked leaf
            for rep, p in enumerate(slot):
                found[id(p)] = value[rep]
        else:
            for s, v in zip(slot, value, strict=True):
                walk(s, v)

    walk(slots, tree)
    params = list(model.parameters())
    if len(found) != len(params):
        raise ValueError(f"the tree places {len(found)} of the model's {len(params)} "
                         f"parameters")
    return [found[id(p)] for p in params]

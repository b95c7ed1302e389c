"""Parameters between the JAX package's tree layout and the port (no JAX here).

`params_from_jax` takes the JAX parameter pytree already converted to numpy
arrays (`jax.tree.map(np.asarray, params)`, done by the caller) and returns
the port's `Model` with identical weights.  `tree_from_model` is its inverse:
the port's parameters, or their gradients, as numpy arrays in the JAX tree
layout, so the two can be compared leaf by leaf.  The JAX tree stacks each
segment's per-period blocks on a leading reps axis; the scan runs
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


def tree_from_model(model: Model, attr: str = "data") -> dict:
    """The JAX tree layout of `model`'s parameters (attr="data") or of their
    gradients (attr="grad") as numpy arrays; bf16 comes back as float32.

    Each segment's per-period blocks are stacked on a leading reps axis, with
    the same key names as `repro.models.init_params`."""
    if attr not in ("data", "grad"):
        raise ValueError(f"attr must be 'data' or 'grad', got {attr!r}")

    def leaves(pdict) -> dict:
        out = {}
        for k, p in pdict.items():
            if isinstance(p, torch.nn.ParameterDict):  # a nested dict
                out[k] = leaves(p)
                continue
            t = getattr(p, attr)
            if t is None:
                raise ValueError(f"parameter {k!r} has no {attr}")
            out[k] = _numpy(t)
        return out

    def stack(trees: list) -> dict:
        """The per-rep dicts of one period position, stacked leaf by leaf."""
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict) else
                np.stack([t[k] for t in trees]) for k, v in trees[0].items()}

    def block_tree(block) -> dict:
        return {name: leaves(block[name]) for name, _ in block.named_children()}

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
        decoder.append([stack(reps_list) for reps_list in per_pos])
    tree["decoder"] = decoder
    if len(model.encoder):
        tree["encoder"] = [[stack([block_tree(b) for b in model.encoder])]]
    if model.patch_proj is not None:
        tree["patch_proj"] = leaves(model.patch_proj)
    return tree

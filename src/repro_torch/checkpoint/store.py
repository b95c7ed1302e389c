"""Step-atomic checkpointing: the port of `repro.checkpoint.store`.

Layout:  <dir>/step_<N:08d>/  arrays.npz  manifest.json   (+ <dir>/LATEST)

The reference's layout, functions and guarantees, in numpy and torch:
  - *atomic*: written to step_<N>.tmp and renamed; a crash mid-save never
    corrupts the restore point (LATEST only advances after the rename).
  - key paths are written as `jax.tree_util.keystr` writes them: a dict key
    as ``['name']`` (keys sorted, as JAX flattens dicts), a list or tuple
    index as ``[i]``, a dataclass field as ``.name`` (the AdamW state's
    ``['opt'].step`` and ``['opt'].m[...]``), so a checkpoint written by
    either package restores in the other.
  - leaves are torch tensors, numpy arrays or scalars.  numpy has no bf16: a
    bf16 tensor is written as its 2-byte words (a ``V2`` array, "bfloat16" in
    the manifest), which is how numpy writes the reference's bf16 arrays, and
    read back through the same words.
Elastic restore onto another mesh stays with the 2-D meshes (ROADMAP A9):
`restore_into` places each leaf on one device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr, leaf) pairs in `jax.tree_util.tree_flatten_with_path` order;
    None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name), f"{prefix}.{f.name}")]
    return [(prefix, tree)]


def _array(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the dtype the manifest names)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _bf16_words(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def save(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _array(v) for k, v in _flatten(tree)}
    arrays = {k: a for k, (a, _) in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: dtype for k, (_, dtype) in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> int | None:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(directory: str, step: int | None = None) -> dict:
    """Raw key->np.ndarray mapping (no tree structure needed); bf16 leaves
    come back as their 2-byte words, as in the reference."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _leaf(arr: np.ndarray, leaf, device):
    """`arr` as `leaf` is: a tensor of its dtype on its device (or `device`),
    or, as in the reference, a numpy array of its dtype."""
    if not isinstance(leaf, torch.Tensor):
        return arr.astype(np.asarray(leaf).dtype)
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if _bf16_words(arr)
         else torch.from_numpy(arr))
    return t.to(device=leaf.device if device is None else device, dtype=leaf.dtype)


def restore_into(directory: str, template, step: int | None = None, device=None):
    """Restore into `template`'s structure (dicts, lists, tuples and
    dataclasses of tensors or numpy arrays).

    Each leaf takes the template leaf's dtype, and a tensor leaf its device
    unless `device` is given (a template of meta tensors costs no memory).
    A key missing from the checkpoint raises KeyError, a shape that differs
    ValueError, as in the reference."""
    raw = restore(directory, step)

    def build(node, prefix: str):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [build(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name), f"{prefix}.{f.name}")
                for f in dataclasses.fields(node)})
        if prefix not in raw:
            raise KeyError(f"checkpoint missing {prefix}")
        arr = raw[prefix]
        shape = tuple(node.shape) if hasattr(node, "shape") else np.shape(node)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                             f"template {shape}")
        return _leaf(arr, node, device)

    return build(template, "")


def garbage_collect(directory: str, keep: int = 3) -> list[str]:
    """Delete all but the newest `keep` checkpoints; returns removed paths."""
    if not os.path.isdir(directory):
        return []
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    removed = []
    for s in steps[:-keep] if keep else steps:
        p = os.path.join(directory, f"step_{s:08d}")
        shutil.rmtree(p)
        removed.append(p)
    return removed

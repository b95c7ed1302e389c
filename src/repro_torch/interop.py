"""Parameters from the JAX package into the port (no JAX needed here).

`params_from_jax` takes the JAX parameter pytree already converted to numpy
arrays (`jax.tree.map(np.asarray, params)`, done by the caller) and returns
the port's `Model` with identical weights.  The JAX tree stacks each
segment's per-period blocks on a leading reps axis; the scan runs
`for rep in range(reps): for pos in period`, so that is the layer order here.
Projections keep the JAX `(d_in, d_out)` layout: the port computes `x @ w`.
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
    """{name: {param: tensor}} of one block (rep-th slice) or one top-level group."""
    return {name: {k: _tensor(a if rep is None else np.asarray(a)[rep], device)
                   for k, a in sub.items()}
            for name, sub in tree.items()}


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device: str | torch.device | None = None) -> Model:
    """tree: JAX `init_params` output as numpy arrays.  Returns a `Model`."""
    dev = resolve_device(device)
    top = _leaves({k: tree[k] for k in ("embed", "unembed", "final_norm")
                   if k in tree}, dev)
    blocks = []
    for si, (kinds, reps) in enumerate(segments(cfg)):
        per_pos = tree["decoder"][si]
        for rep in range(reps):
            for pos in range(len(kinds)):
                blocks.append(_leaves(per_pos[pos], dev, rep))
    return Model(cfg, top["embed"], top.get("unembed"), top["final_norm"], blocks)

"""GPipe-style pipeline parallelism over a mesh axis: the port of
`repro.launch.pipeline`.

Each rank along the axis holds one contiguous stage of layers; microbatches
stream through with a cyclic shift by +1 (the reference's `ppermute(+1)`,
here `collectives.shift(y, 1, group)`) per tick — `n_micro + n_stages - 1`
ticks in all (the classic GPipe schedule; bubble fraction (S-1)/(M+S-1)).
Forward only, as the reference's.

A stage runs its `stage_fn` only on the ticks where it holds a microbatch
(stage s at tick t holds microbatch t - s); the reference computes every
tick and discards the rest, which changes no output, and the shift still
runs every tick on every stage, as the reference's does.

Any `stage_fn(stage_params, x) -> x` works: the tests run the reference's
tanh stages; `chip_smoke.py` runs stablelm-3b's blocks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.collectives import shift


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, group=None) -> torch.Tensor:
    """Run microbatches through the pipeline stages of `group` (one stage a
    rank, in rank order).  x_micro: (M, mb, ...) all microbatches (only
    stage 0 reads them).  Returns (M, mb, ...) final-stage outputs (valid on
    the last stage; the other stages return zeros), for the caller's sum."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x_micro.shape[0]
    out = torch.zeros_like(x_micro)
    carry = torch.zeros_like(x_micro[0])
    for t in range(m + n - 1):
        if 0 <= t - idx < m:
            # stage 0 ingests microbatch t; the others take the carry
            y = stage_fn(stage_params, x_micro[t] if idx == 0 else carry)
            if idx == n - 1:  # the last stage finishes microbatch t - (n - 1)
                out[t - (n - 1)] = y
        else:
            y = torch.zeros_like(carry)
        carry = shift(y, 1, group)  # hand activations to the next stage
    return out


def run_pipeline(mesh, axis_name: str, stage_fn, all_stage_params, x: torch.Tensor,
                 n_micro: int) -> torch.Tensor:
    """Each rank takes its stage of `all_stage_params` (indexed by stage: a
    tensor with a leading n_stages dim, or a sequence), splits x into
    microbatches, runs the pipeline over the mesh axis and returns the
    outputs on every rank (the stages' sum, over the stage group).

    x: (batch, ...) with batch % n_micro == 0."""
    group = mesh.get_group(axis_name)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    stage_params = all_stage_params[dist.get_rank(group)]
    x_micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    out = pipeline_apply(stage_fn, stage_params, x_micro, group)
    # every stage returns the final stage's outputs
    dist.all_reduce(out, group=group)
    return out.reshape(b, *out.shape[2:])

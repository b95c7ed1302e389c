"""Gradient compression for the data-parallel sync path.

The port of `repro.collectives.compression`: int8 uniform quantization with
*error feedback* (residual accumulation), the standard trick to keep
SGD/Adam convergence while cutting collective bytes by ~4x (Seide et al.
1-bit SGD lineage).  A single scalar max |g| is agreed by an all-reduce with
MAX (the reference's `pmax`) so all ranks share one dequantization scale;
the int8 payloads are summed in int32 by an all-reduce with SUM (its
`psum`).  A group of one rank (or no process group) reduces nothing, as an
axis of size one does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def make_error_feedback_state(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Zero residuals (float32) matching the gradient leaves."""
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, as jnp.round, rounds half to even
    q = torch.round(v / torch.clamp_min(scale, 1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def compressed_all_reduce(grads: list[torch.Tensor], ef_state: list[torch.Tensor],
                          group=None) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """All-reduce-sum gradient leaves in int8 with error feedback.

    Returns (summed_grads, new_ef_state), both float32.  The residuals are
    written into `ef_state`'s tensors, which are returned: a training step
    then holds one copy of them, not two.  Wire format: int8 payload
    (carried in int32 for the sum) + one f32 scale per tensor."""
    if len(grads) != len(ef_state):
        raise ValueError(f"{len(grads)} gradients for {len(ef_state)} residuals")
    summed = []
    for g, e in zip(grads, ef_state, strict=True):
        v = g.float() + e
        scale = _all_reduce(v.abs().max(), dist.ReduceOp.MAX, group) / 127.0
        q = _quantize(v, scale)
        torch.sub(v, q.float() * scale, out=e)  # residual kept locally (error feedback)
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        summed.append(total.float() * scale)
    return summed, ef_state

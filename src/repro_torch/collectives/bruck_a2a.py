"""Bruck all-to-all over `torch.distributed` (log-step, subring-patterned).

The port of `repro.collectives.bruck_a2a`.  The input is the local tensor `x`
of shape (n, ...) where row j is the block destined for rank j of the group.
Returns a tensor of the same shape whose row p is the block received from
rank p: the semantics of `dist.all_to_all_single` with equal splits along
dim 0, but communicated in ceil(log2 n) shifts at offsets 2^k (the paper's
Bruck pattern, Section 3.1) instead of one monolithic all-to-all.  Pure data
movement: the result equals the library's bit for bit.

On an OCS fabric each step is a single hop after a BRIDGE reconfiguration;
on a static ring the offset-2^k shift crosses min(2^k, n - 2^k) hops, the
same h_k the cost model scores.

The exchange is differentiable (the MoE's expert-parallel dispatch runs it
inside the model): an all-to-all is its own transpose, so the gradient of
the output comes back to the input through the same exchange.
`bruck_all_to_all.calls` counts exchanges, forward and backward alike.
"""
from __future__ import annotations

import torch

from repro_torch.core.bruck import num_steps

from .bruck_rs_ag import _world, shift


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    bruck_all_to_all.calls += 1
    n, i = _world(group)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != group size {n}")
    if n == 1:
        return x
    slots = torch.arange(n, device=x.device)

    # Phase 1 — local rotation: slot j holds the block destined for (i + j) % n.
    buf = x[(i + slots) % n]

    # Phase 2 — in round k send every slot whose k-th bit is set to the rank at
    # offset +2^k.  Slot sets are static (independent of i).
    for k in range(num_steps(n)):
        send = torch.tensor([j for j in range(n) if (j >> k) & 1], dtype=torch.long,
                            device=x.device)
        buf[send] = shift(buf[send], 2**k, group)

    # Phase 3 — inverse rotation: after phase 2, slot j holds the block destined
    # for me that originated at (i - j) % n, so out[p] = buf[(i - p) % n].
    return buf[(i - slots) % n]


class _AllToAll(torch.autograd.Function):
    """The exchange with its backward: row p of the output on rank i is row i
    of rank p's input, so d input[j] on rank i is d output[i] on rank j, which
    is the exchange applied to the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group), None


def bruck_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Log-step all-to-all; x.shape[0] must equal the group size."""
    return _AllToAll.apply(x, group)


bruck_all_to_all.calls = 0

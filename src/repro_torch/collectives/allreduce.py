"""AllReduce implementations: BRIDGE (Bruck RS + AG) and RING, over
`torch.distributed`.

The port of `repro.collectives.allreduce`.  `bridge_all_reduce` is the paper's
technique end-to-end: Rabenseifner decomposition with a BRIDGE-scheduled
Reduce-Scatter (early reconfigurations) followed by a BRIDGE-scheduled
AllGather (late reconfigurations).  The library all-reduce
(`dist.all_reduce`) plays the part of the reference's `psum` oracle.  Unlike
the reference, which defaults to its TPU cost model, `bridge_all_reduce` takes
the cost model from its caller.
"""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.schedules import Schedule
from repro_torch.planner import PlanRequest, default_planner

from .bruck_rs_ag import _world, bruck_all_gather, bruck_reduce_scatter, shift


def _to_chunks(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Flatten x and pad so it splits into n equal chunks: (n, chunk)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype, device=flat.device)])
    return flat.reshape(n, -1), pad


def _from_chunks(chunks: torch.Tensor, pad: int, shape, dtype) -> torch.Tensor:
    flat = chunks.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


# --- Ring (bandwidth-optimal baseline; paper Section 2) ----------------------


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """x: (n, ...) contributions; rank i returns reduced block i.
    n - 1 unit-offset steps (neighbor-only: no congestion, minimal bytes)."""
    n, i = _world(group)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != group size {n}")
    if n == 1:
        return x[0]
    acc = x.clone()
    for t in range(n - 1):
        recv = shift(acc[(i - 1 - t) % n], 1, group)
        acc[(i - 2 - t) % n] += recv
    return acc[i]


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """x: (...) local block; returns (n, ...): n - 1 unit-offset steps."""
    n, i = _world(group)
    if n == 1:
        return x[None]
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[i] = x
    for t in range(n - 1):
        buf[(i - 1 - t) % n] = shift(buf[(i - t) % n], 1, group)
    return buf


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce (sum), any shape."""
    n, _ = _world(group)
    if n == 1:
        return x
    chunks, pad = _to_chunks(x, n)
    mine = ring_reduce_scatter(chunks, group)
    full = ring_all_gather(mine, group)
    return _from_chunks(full, pad, x.shape, x.dtype)


# --- BRIDGE / Bruck -----------------------------------------------------------


def bruck_all_reduce(
    x: torch.Tensor,
    rs_schedule: Schedule | None = None,
    ag_schedule: Schedule | None = None,
    group=None,
) -> torch.Tensor:
    """AllReduce (sum) via Bruck RS + Bruck AG in 2 ceil(log2 n) steps.

    With schedules given, the shift chain follows the BRIDGE subring
    store-and-forward execution (see bruck_rs_ag docstring)."""
    n, _ = _world(group)
    if n == 1:
        return x
    chunks, pad = _to_chunks(x, n)
    mine = bruck_reduce_scatter(chunks, rs_schedule, group)
    full = bruck_all_gather(mine, ag_schedule, group)
    return _from_chunks(full, pad, x.shape, x.dtype)


def bridge_all_reduce(
    x: torch.Tensor,
    cost_model: CostModel,
    m_bytes: float | None = None,
    paper_faithful: bool = True,
    group=None,
) -> torch.Tensor:
    """The paper's AllReduce: optimal-R BRIDGE schedules for both phases,
    planned for this group's size under `cost_model`."""
    n, _ = _world(group)
    if n == 1:
        return x
    if m_bytes is None:
        m_bytes = float(x.numel() * x.element_size())
    planner = default_planner()
    rs, ag = (planner.plan(PlanRequest(kind=kind, n=n, m_bytes=float(m_bytes),
                                       cost_model=cost_model,
                                       paper_faithful=paper_faithful)).schedule
              for kind in ("rs", "ag"))
    return bruck_all_reduce(x, rs, ag, group)

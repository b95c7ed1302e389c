"""Glue: BRIDGE schedule synthesis -> collective implementation choice.

The port of `repro.collectives.schedule_bridge`, with the same contract and
fields.  The reference defaults the cost model to its TPU preset; here the
caller passes it (the training driver passes `core.cost_model.H100_NVLINK`).
The deprecated `plan_gradient_sync` alias is not carried over.

`gradient_sync_plan` is the deployment entry point: given the data-parallel
group size and the gradient payload, it plans the paper's Section 3.6
composite AllReduce under the hardware cost model and returns which
collective implementation the training step should run (and with which
reconfiguration schedules).  It is a thin wrapper over the unified planner:
one `PlanRequest` with the composite kind ``ar`` (= RS phase + AG phase,
Rabenseifner decomposition), mapped back onto the `CollectivePlan` shape.

The implementations trade off exactly the terms the paper's model scores:
  ring  : 2(n-1) unit-offset steps — bandwidth-optimal, latency Omega(n)
  bruck : 2 log2(n) steps at offsets 2^k — latency-optimal, h_k-hop shifts
  psum  : the library all-reduce (`dist.all_reduce`) as the fallback
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import CostModel
from repro_torch.core.jsonio import FabricKind
from repro_torch.core.schedules import Schedule
from repro_torch.planner import PlanRequest, default_planner, default_strategy_names


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    impl: str                      # 'bruck' | 'ring' | 'psum'
    rs_schedule: Schedule | None
    ag_schedule: Schedule | None
    predicted_time: float
    alternatives: dict[str, float]


def gradient_sync_plan(
    n: int,
    m_bytes: float,
    cm: CostModel,
    allow: tuple[str, ...] = ("bruck", "ring"),
    fabric: FabricKind = FabricKind.STATIC,
) -> CollectivePlan:
    """Pick the best gradient-allreduce strategy for n devices / m bytes.

    fabric=STATIC (TPU ICI): Bruck is costed with *static* semantics — a
    step at offset 2^k pays h = c = 2^k regardless of schedule (there is no
    OCS to rewire; DESIGN.md S3) and the returned schedules are None so the
    lowering emits one ppermute per Bruck step.  fabric=OCS uses the
    paper's model where reconfigurations reset hop distances, and the
    returned schedules drive the optical fabric.

    Thin wrapper over ``default_planner().plan(PlanRequest(kind='ar', ...))``
    (the shared LRU-cached serving path — a training loop re-planning the
    same gradient sync every step gets an amortized-O(1) answer).
    """
    fabric = FabricKind.coerce(fabric, warn=False)
    names: tuple[str, ...] = ()
    if "bruck" in allow:
        names += default_strategy_names()
    if "ring" in allow:
        names += ("ring",)
    if n <= 1 or not names:
        return CollectivePlan("psum", None, None, 0.0, {})

    res = default_planner().plan(PlanRequest(
        kind="ar", n=n, m_bytes=float(m_bytes), cost_model=cm,
        fabric=fabric, strategies=names))

    alts: dict[str, float] = {}
    for a in res.alternatives:
        t = alts.get(a.impl)
        alts[a.impl] = a.predicted_time if t is None else min(t, a.predicted_time)
    use_schedules = res.impl == "bruck" and fabric == FabricKind.OCS
    return CollectivePlan(
        impl=res.impl,
        rs_schedule=res.rs_schedule if use_schedules else None,
        ag_schedule=res.ag_schedule if use_schedules else None,
        predicted_time=res.predicted_time,
        alternatives=alts,
    )

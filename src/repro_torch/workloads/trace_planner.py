"""Cross-collective trace planning with fabric-state carryover.

`plan_trace` extends the per-collective exact-R planning across collective
boundaries.  The fabric's final link offsets from collective i are the
initial configuration of collective i+1, so the boundary pays delta only on
the circuits that actually change (`core.schedules.changed_links`) — and a
boundary where collective i ends on exactly the offsets collective i+1
starts with is free.  Three planning modes:

  - ``carryover`` : joint DP over the whole trace.  Every phase contributes
                    its full all-R candidate table (the planner's ranked
                    alternatives, themselves products of the exact segment-
                    partition DPs), the DP state is (final link offset,
                    reconfigurations spent), transitions charge the sparse
                    boundary cost, and a trace-wide ``delta_budget`` caps
                    the total intra-collective reconfiguration stall
                    *jointly* — R migrates to the collectives that benefit
                    instead of being rationed per collective.
  - ``cold``      : today's per-collective view.  Each phase is planned
                    independently (a ``delta_budget`` is split evenly across
                    phases — the greedy allocation), and every boundary
                    re-establishes the next phase's initial topology with a
                    full-fabric swap (all n circuits, one effective delta).
  - ``static``    : every phase runs the static (R=0, ring) schedule; the
                    fabric never reconfigures and all boundaries are free.

The carryover candidate set contains every cold choice and its boundary
charges are never larger, so ``carryover <= cold`` holds pointwise — the
trace-bench gate.  A composite 'ar' event is flattened to its RS + AG
phases first, so the RS->AG transition is just another carryover boundary.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.jsonio import FabricKind
from repro_torch.core.schedules import Schedule, changed_links, static_schedule
from repro_torch.core.simulator import collective_time, collective_time_overlap

from .traces import Trace

TRACE_PLAN_MODES = ("carryover", "cold", "static")
#: fabrics a trace/window DP can price analytically (enum members; bare
#: strings compare equal, so legacy membership checks keep working)
TRACE_FABRICS = (FabricKind.OCS, FabricKind.OCS_OVERLAP)


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """One planned single-collective phase of a trace."""

    kind: str
    m_bytes: float
    tag: str
    strategy: str
    schedule: Schedule
    time: float            # modeled completion time, boundary cost excluded
    paid_reconfigs: int    # intra-collective boundaries that rewire circuits

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "m_bytes": self.m_bytes, "tag": self.tag,
            "strategy": self.strategy,
            "schedule": {"kind": self.schedule.kind, "n": self.schedule.n,
                         "x": list(self.schedule.x), "r": self.schedule.r},
            "time": self.time, "paid_reconfigs": self.paid_reconfigs,
        }

    @staticmethod
    def from_dict(d: dict) -> "PhasePlan":
        s = d["schedule"]
        return PhasePlan(
            kind=d["kind"], m_bytes=d["m_bytes"], tag=d["tag"],
            strategy=d["strategy"],
            schedule=Schedule(kind=s["kind"], n=s["n"], x=tuple(s["x"]),
                              r=s["r"]),
            time=d["time"], paid_reconfigs=d["paid_reconfigs"])


@dataclasses.dataclass(frozen=True)
class TracePlan:
    """Outcome of one `plan_trace` call (lossless JSON round trip)."""

    trace: Trace
    mode: str
    fabric: FabricKind
    overlap: float
    delta_budget: float | None
    phases: tuple[PhasePlan, ...]
    boundary_changed: tuple[int, ...]  # circuits rewired per phase boundary
    boundary_cost: tuple[float, ...]   # effective stall charged per boundary
    total_time: float

    @property
    def phase_time(self) -> float:
        return sum(p.time for p in self.phases)

    @property
    def boundary_time(self) -> float:
        return sum(self.boundary_cost)

    @property
    def free_boundaries(self) -> int:
        """Boundaries where the next collective reuses the fabric as-is."""
        return sum(1 for c in self.boundary_changed if c == 0)

    @property
    def paid_reconfigs(self) -> int:
        return sum(p.paid_reconfigs for p in self.phases)

    def schedules(self) -> tuple[Schedule, ...]:
        return tuple(p.schedule for p in self.phases)

    def fabric_phases(self) -> tuple[tuple[Schedule, float], ...]:
        """(schedule, m) pairs for `FabricSim.run_trace` / `batch_run_trace`."""
        return tuple((p.schedule, p.m_bytes) for p in self.phases)

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "trace": self.trace.to_dict(),
            "mode": self.mode, "fabric": str(self.fabric),
            "overlap": self.overlap, "delta_budget": self.delta_budget,
            "phases": [p.to_dict() for p in self.phases],
            "boundary_changed": list(self.boundary_changed),
            "boundary_cost": list(self.boundary_cost),
            "total_time": self.total_time,
        }

    @staticmethod
    def from_dict(d: dict) -> "TracePlan":
        return TracePlan(
            trace=Trace.from_dict(d["trace"]),
            mode=d["mode"], fabric=FabricKind.coerce(d["fabric"], warn=False),
            overlap=d["overlap"],
            delta_budget=d["delta_budget"],
            phases=tuple(PhasePlan.from_dict(p) for p in d["phases"]),
            boundary_changed=tuple(d["boundary_changed"]),
            boundary_cost=tuple(d["boundary_cost"]),
            total_time=d["total_time"])

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "TracePlan":
        return TracePlan.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class PhaseCandidate:
    """One evaluable schedule for one phase of the joint DP.

    time is the phase's modeled completion (boundary costs excluded); paid
    counts its intra-collective circuit-rewiring boundaries; g_first / g_last
    are the link offsets the schedule starts and ends on — the DP charges
    `CostModel.delta_sparse(changed_links(n, g, g_first), overlap)` to enter
    the candidate from a fabric left at offset g.
    """

    strategy: str
    schedule: Schedule
    time: float
    paid: int
    g_first: int
    g_last: int


def _phase_time(sched: Schedule, m: float, cm: CostModel, fabric: str,
                overlap: float) -> float:
    if fabric == "ocs-overlap":
        return collective_time_overlap(sched, m, cm, overlap).total
    return collective_time(sched, m, cm).total


def phase_candidates(kind: str, n: int, r: int, m: float, cm: CostModel,
                     fabric: FabricKind, overlap: float,
                     planner, tenant: str | None = None
                     ) -> list[PhaseCandidate]:
    """Full all-R candidate table of one phase, from the planner's ranked
    alternatives (ring-impl rows carry no schedule and are skipped).  Goes
    through the planner's plan cache, so repeated (kind, m) phases — and the
    online planner's re-plans over a shifted window — pay for the table once.
    ``tenant`` tags the underlying `PlanRequest` (and therefore the plan-
    cache key) with the requesting tenant's identity, so multi-tenant
    serving never shares cached tables across tenants.
    """
    from repro_torch.planner import PlanRequest  # deferred: planner imports core

    res = planner.plan(PlanRequest(kind=kind, n=n, m_bytes=m, cost_model=cm,
                                   r=r, fabric=FabricKind.coerce(fabric),
                                   overlap=overlap, tenant=tenant))
    out = []
    for alt in res.alternatives:
        if alt.x is None:
            continue
        sched = Schedule(kind=kind, n=n, x=tuple(alt.x), r=r)
        offs = sched.link_offsets()
        out.append(PhaseCandidate(
            strategy=alt.strategy, schedule=sched, time=alt.predicted_time,
            paid=sum(1 for c in sched.reconfig_changed_links() if c),
            g_first=offs[0], g_last=offs[-1]))
    return out


def _phase_plan(kind: str, m: float, tag: str,
                cand: PhaseCandidate) -> PhasePlan:
    return PhasePlan(kind=kind, m_bytes=m, tag=tag, strategy=cand.strategy,
                     schedule=cand.schedule, time=cand.time,
                     paid_reconfigs=cand.paid)


def window_dp(n: int, cand_lists: Sequence[Sequence[PhaseCandidate]],
              cm: CostModel, *, overlap: float = 0.0,
              init_g: int | None = None, init_spent: int = 0,
              cap: int | None = None,
              label: str = "window") -> list[PhaseCandidate]:
    """Joint (link offset, reconfigs spent) DP over a window of phases.

    The carryover DP of `plan_trace`, factored out so the receding-horizon
    online planner can warm-start it mid-trace: ``init_g`` is the link offset
    the fabric was left at by already-committed collectives (None = fresh
    fabric, no entry boundary), ``init_spent`` the paid intra-collective
    reconfigurations already committed against the trace-wide cap, and
    ``cap`` the absolute cap itself (None = unbounded).  Entering the first
    window phase from ``init_g`` charges the sparse changed-circuit diff
    exactly like any later boundary.  Returns the chosen candidate per phase
    (ties broken identically to `plan_trace`: strict improvement only, final
    state broken by smallest (total, key)).
    """
    if not cand_lists:
        raise ValueError("window_dp needs at least one phase")
    # state: (final link offset, paid intra reconfigs so far) ->
    #        (best total, predecessor state, winning candidate)
    layers: list[dict] = []
    cur: dict = {}
    for cand in cand_lists[0]:
        spent = init_spent + cand.paid
        if cap is not None and spent > cap:
            continue
        t = cand.time
        if init_g is not None:
            t = cm.delta_sparse(
                changed_links(n, init_g, cand.g_first), overlap) + cand.time
        key = (cand.g_last, spent)
        if key not in cur or t < cur[key][0]:
            cur[key] = (t, None, cand)
    for p in range(1, len(cand_lists)):
        layers.append(cur)
        nxt: dict = {}
        for (g, spent), (total, _, _) in cur.items():
            for cand in cand_lists[p]:
                spent2 = spent + cand.paid
                if cap is not None and spent2 > cap:
                    continue
                t2 = (total + cm.delta_sparse(
                    changed_links(n, g, cand.g_first), overlap) + cand.time)
                key = (cand.g_last, spent2)
                if key not in nxt or t2 < nxt[key][0]:
                    nxt[key] = (t2, (g, spent), cand)
        cur = nxt
    if not cur:
        raise ValueError(
            f"reconfiguration cap {cap} is infeasible for the "
            f"{len(cand_lists)}-phase {label} with {init_spent} already "
            f"spent (even R=0 schedules do not fit)")

    best_key = min(cur, key=lambda k: (cur[k][0], k))
    chosen: list[PhaseCandidate] = []
    key = best_key
    for layer in reversed(layers + [cur]):
        total, prev_key, cand = layer[key]
        chosen.append(cand)
        key = prev_key
    chosen.reverse()
    return chosen


def _finish(trace: Trace, mode: str, fabric: str, overlap: float,
            delta_budget: float | None, cm: CostModel,
            phases: list[PhasePlan], full_boundaries: bool) -> TracePlan:
    """Assemble boundary accounting + totals for a chosen phase sequence."""
    n = trace.n
    boundary_changed, boundary_cost = [], []
    for prev, nxt in zip(phases, phases[1:], strict=False):
        if full_boundaries:
            # cold fabric: the next phase's initial topology is always
            # re-established with a full-fabric swap
            bc = n
        else:
            bc = changed_links(n, prev.schedule.link_offsets()[-1],
                               nxt.schedule.link_offsets()[0])
        boundary_changed.append(bc)
        boundary_cost.append(cm.delta_sparse(bc, overlap))
    total = sum(p.time for p in phases) + sum(boundary_cost)
    return TracePlan(
        trace=trace, mode=mode, fabric=fabric, overlap=overlap,
        delta_budget=delta_budget, phases=tuple(phases),
        boundary_changed=tuple(boundary_changed),
        boundary_cost=tuple(boundary_cost), total_time=total)


def plan_trace(trace: Trace, cm: CostModel = PAPER_DEFAULT, *,
               mode: str = "carryover", fabric: FabricKind = FabricKind.OCS,
               overlap: float = 0.0, delta_budget: float | None = None,
               planner=None, tenant: str | None = None) -> TracePlan:
    """Plan every collective of ``trace`` under one of the three modes.

    fabric       : 'ocs' (flat delta per intra-collective reconfiguration)
                   or 'ocs-overlap' (sparse hidden-delta credit, see
                   `core.simulator.collective_time_overlap`); boundaries are
                   always charged sparsely except in ``cold`` mode.
    delta_budget : cap on total *intra-collective* reconfiguration stall
                   across the whole trace, seconds.  ``carryover`` spends it
                   jointly (the DP's second state dimension); ``cold``
                   rations it evenly across phases.  Boundary swaps are the
                   carryover surcharge and are not counted against it.
    planner      : a `repro_torch.planner.Planner` (defaults to the process-wide
                   `default_planner()`, sharing its plan cache).
    tenant       : requesting tenant's identity; tags every underlying
                   `PlanRequest` so the shared plan cache is tenant-keyed.
    """
    if mode not in TRACE_PLAN_MODES:
        raise ValueError(f"mode must be one of {TRACE_PLAN_MODES}, got {mode!r}")
    fabric = FabricKind.coerce(fabric)
    if fabric not in TRACE_FABRICS:
        raise ValueError(
            f"fabric must be one of {tuple(map(str, TRACE_FABRICS))}, "
            f"got {str(fabric)!r} (event-level scoring of a planned trace "
            f"goes through FabricSim.run_trace)")
    if overlap and fabric != "ocs-overlap":
        raise ValueError(f"overlap={overlap} requires fabric='ocs-overlap'")
    if delta_budget is not None and delta_budget < 0:
        raise ValueError(f"delta_budget must be >= 0, got {delta_budget}")
    if planner is None:
        from repro_torch.planner import default_planner  # deferred: no cycle

        planner = default_planner()
    n, r = trace.n, trace.r
    phases = trace.phases()

    if mode == "static":
        plans = []
        for kind, m, tag in phases:
            sched = static_schedule(kind, n, r)
            plans.append(PhasePlan(
                kind=kind, m_bytes=m, tag=tag, strategy="static",
                schedule=sched,
                time=_phase_time(sched, m, cm, fabric, overlap),
                paid_reconfigs=0))
        return _finish(trace, mode, fabric, overlap, delta_budget, cm, plans,
                       full_boundaries=False)

    if mode == "cold":
        from repro_torch.planner import PlanRequest  # deferred: no cycle

        per_phase_budget = (None if delta_budget is None
                            else delta_budget / len(phases))
        plans = []
        for kind, m, tag in phases:
            res = planner.plan(PlanRequest(
                kind=kind, n=n, m_bytes=m, cost_model=cm, r=r, fabric=fabric,
                overlap=overlap, delta_budget=per_phase_budget,
                tenant=tenant))
            sched = res.schedule
            assert sched is not None
            plans.append(PhasePlan(
                kind=kind, m_bytes=m, tag=tag, strategy=res.strategy,
                schedule=sched, time=res.predicted_time,
                paid_reconfigs=sum(
                    1 for c in sched.reconfig_changed_links() if c)))
        return _finish(trace, mode, fabric, overlap, delta_budget, cm, plans,
                       full_boundaries=True)

    # --- carryover: joint DP across collective boundaries ---------------------
    unit = cm.delta_sparse(n, overlap)  # effective stall of one paid swap
    cap: int | None = None
    if delta_budget is not None and unit > 0:
        cap = int(delta_budget / unit + 1e-12)
    cand_lists = [phase_candidates(kind, n, r, m, cm, fabric, overlap, planner,
                                   tenant=tenant)
                  for kind, m, _ in phases]
    chosen = window_dp(n, cand_lists, cm, overlap=overlap, cap=cap,
                       label=f"trace {trace.name!r}")
    plans = [_phase_plan(kind, m, tag, cand)
             for (kind, m, tag), cand in zip(phases, chosen, strict=True)]
    return _finish(trace, mode, fabric, overlap, delta_budget, cm, plans,
                   full_boundaries=False)

"""Built-in strategy families (paper Sections 3.3-3.6 + baselines).

Each family materializes its candidates from one all-R DP pass in
`repro.core.schedules` (`*_all` functions), so generating the full candidate
set costs one O(S^3) table per family instead of one capped DP per R.

Registration order matters for exact ties (first minimum wins) and mirrors
the legacy `candidate_schedules` priority: the paper's families first, the
beyond-paper exact DP next, then the degenerate endpoints and the ring
baseline.
"""
from __future__ import annotations

from repro_torch.core import schedules as core_schedules
from repro_torch.core.schedules import every_step_schedule, static_schedule

from .api import Candidate, FabricKind, PlanRequest
from .registry import register_strategy


@register_strategy("periodic")
def periodic_family(req: PlanRequest, kind: str):
    """Theorem 3.2 latency-optimal (periodic) schedules for every R; RS/AG
    share the A2A optimum (AG reversed, Sections 3.5-3.6)."""
    for R, sched in enumerate(core_schedules.periodic_all(kind, req.n, req.r)):
        yield Candidate(f"periodic(R={R})", sched)


@register_strategy("rs-early", kinds=("rs",))
def rs_early_family(req: PlanRequest, kind: str):
    """Theorem 3.3 transmission-optimal Reduce-Scatter schedules (early
    reconfigurations), every R."""
    for R, sched in enumerate(
            core_schedules.rs_transmission_optimal_all(req.n, req.r)):
        yield Candidate(f"rs-early(R={R})", sched)


@register_strategy("ag-late", kinds=("ag",))
def ag_late_family(req: PlanRequest, kind: str):
    """Section 3.5 AllGather optima: time-reversed Reduce-Scatter schedules
    (late reconfigurations), every R."""
    for R, sched in enumerate(
            core_schedules.ag_transmission_optimal_all(req.n, req.r)):
        yield Candidate(f"ag-late(R={R})", sched)


@register_strategy("exact-dp", paper_faithful=False)
def exact_dp_family(req: PlanRequest, kind: str):
    """Beyond-paper: joint latency+transmission optimum per R under the full
    cost model (dominates both paper families)."""
    scheds = core_schedules.full_cost_optimal_all(
        kind, req.n, float(req.m_bytes), req.cost_model, req.r)
    for R, sched in enumerate(scheds):
        yield Candidate(f"exact-dp(R={R})", sched)


@register_strategy("overlap", paper_faithful=False)
def overlap_family(req: PlanRequest, kind: str):
    """Sparse-reconfiguration overlap family (ocs-overlap / ocs-sim fabrics):
    re-scores the periodic and exact-dp candidate schedules under the
    hidden-delta credit `CostModel.delta_sparse(changed, overlap)` — or,
    for 'ocs-sim', under the batched event simulation.

    Per fixed R the optimal segment partition is delta-independent, so the
    candidates coincide with the periodic / exact-dp tables; what changes is
    the scoring — with most of delta hidden, higher-R schedules win at
    (delta, m) points where the full-pause model would stay static.  The
    planner evaluates *every* candidate with `collective_time_overlap`
    (or the batch engine) on these fabrics, so this family's role is to
    guarantee the schedule tables are in the candidate set even under an
    explicit ``strategies=("overlap",)`` subset."""
    if req.fabric not in (FabricKind.OCS_OVERLAP, FabricKind.OCS_SIM):
        return
    for R, sched in enumerate(core_schedules.periodic_all(kind, req.n, req.r)):
        yield Candidate(f"overlap[periodic](R={R})", sched)
    exact = core_schedules.full_cost_optimal_all(
        kind, req.n, float(req.m_bytes), req.cost_model, req.r)
    for R, sched in enumerate(exact):
        yield Candidate(f"overlap[exact-dp](R={R})", sched)


@register_strategy("static")
def static_family(req: PlanRequest, kind: str):
    """S-BRUCK endpoint: never reconfigure (the only feasible schedule on a
    static fabric)."""
    yield Candidate("static", static_schedule(kind, req.n, req.r))


@register_strategy("every-step")
def every_step_family(req: PlanRequest, kind: str):
    """G-BRUCK endpoint: reconfigure before every sub-step after the first."""
    yield Candidate("every-step", every_step_schedule(kind, req.n, req.r))


@register_strategy("ring", kinds=("rs", "ag", "ar"), default=False)
def ring_family(req: PlanRequest, kind: str):
    """Bandwidth-optimal ring baseline — an implementation-level alternative
    (no Bruck schedule), costed by `core.baselines.ring`."""
    yield Candidate("ring", None, impl="ring")

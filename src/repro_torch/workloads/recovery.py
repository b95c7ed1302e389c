"""Degraded-mode re-planning: from a `DegradedState` back to a running trace.

`FabricSim.run_trace(..., faults=...)` ends a faulted trace with a
`core.faults.DegradedState`: the committed collective prefix, its exact
`FabricSnapshot`, the surviving world, and the fate of the in-flight chunks.
This module closes the loop — failure → snapshot → re-plan → verify:

  1. `split_events` maps the committed *phase* count back to whole
     `CollectiveEvent`s (a composite 'ar' spans an RS + AG phase pair and is
     only committed when both drained — a half-committed AllReduce re-runs
     in full, recovery never trusts partially-delivered collective state).
  2. `reduced_trace` rebuilds the remaining stream at the surviving world
     size (the arbitrary-n schedule core makes shrink/grow worlds legal,
     including a node-join's n+1).
  3. `replan_after_fault` treats the failure as the ultimate misprediction:
     every event planned beyond the committed prefix is dropped, and a fresh
     `OnlinePlanner` at the reduced n re-plans the remaining stream with the
     window covering all of it — which makes the recovery plan bit-identical
     to the offline `plan_trace(mode='carryover')` of the reduced trace (the
     W-equals-stream anchor pinned by tests/test_online_planner.py).  The
     re-plan is *cold* (no ``init_g``): after an abort the parked circuits
     are untrustworthy — a dead link or a changed world — so recovery
     re-establishes topology, while the snapshot still supplies the resume
     clock and the committed accounting.
  4. `run_with_recovery` measures the payoff: resume-from-snapshot completion
     (resume clock + remaining-stream run at n') vs restart-from-scratch
     (resume clock + the *whole* trace re-planned and re-run at n'), executes
     the recovery plan and the clean reduced-world plan on a fresh fabric to
     check bit-identity, and audits everything with the ``fault/*`` verifier
     rules (`repro_torch.analysis`).

`benchmarks/faults_bench.py` grids this over fault kind x n x delta x
failure time and gates ``recovery_ratio <= 1`` plus bit-identity on every
row (BENCH_faults.json).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.fabricsim import FabricSim, TraceFabricResult
from repro_torch.core.jsonio import FabricKind
from repro_torch.core.faults import DegradedState, FaultTimeline

from .online_planner import OnlinePlanner, OnlineStats
from .trace_planner import TracePlan, plan_trace
from .traces import CollectiveEvent, Trace


def split_events(trace: Trace, completed_phases: int
                 ) -> tuple[tuple[CollectiveEvent, ...],
                            tuple[CollectiveEvent, ...]]:
    """(committed, remaining) events for a committed *phase* count.

    An event is committed only when every phase it flattens to drained
    ('ar' = its RS + AG pair); an event with any un-committed phase lands in
    ``remaining`` and re-runs in full on recovery.
    """
    if completed_phases < 0:
        raise ValueError(
            f"completed_phases must be >= 0, got {completed_phases}")
    done = 0
    committed: list[CollectiveEvent] = []
    for i, ev in enumerate(trace.events):
        width = 2 if ev.kind == "ar" else 1
        if done + width > completed_phases:
            return tuple(committed), trace.events[i:]
        committed.append(ev)
        done += width
    if completed_phases > done:
        raise ValueError(
            f"completed_phases={completed_phases} exceeds the trace's "
            f"{done} phases")
    return tuple(committed), ()


def reduced_trace(trace: Trace, degraded: DegradedState) -> Trace:
    """Remaining stream of ``trace`` re-targeted at the surviving world."""
    if degraded.n != trace.n:
        raise ValueError(
            f"degraded state is for n={degraded.n}, trace has n={trace.n}")
    _, remaining = split_events(trace, degraded.completed_phases)
    if not remaining:
        raise ValueError(
            "nothing left to recover: every event of the trace committed")
    return Trace(name=f"{trace.name}+recovery", n=degraded.new_n, r=trace.r,
                 events=remaining)


def replan_after_fault(trace: Trace, degraded: DegradedState,
                       cm: CostModel = PAPER_DEFAULT, *,
                       fabric: FabricKind = FabricKind.OCS,
                       overlap: float = 0.0,
                       delta_budget: float | None = None, planner=None,
                       verify: bool = True) -> tuple[TracePlan, OnlineStats]:
    """Re-plan the remaining stream over the surviving world.

    Every prediction beyond the committed prefix is dropped (the fault
    invalidated the world they were planned for — each drop is counted as a
    misprediction in the returned `OnlineStats`) and a fresh `OnlinePlanner`
    at the reduced n re-plans the survivors with the window spanning the
    whole remaining stream, so the recovery plan is bit-identical to the
    offline carryover plan of `reduced_trace` — the recovered result then
    matches a clean run of the reduced world exactly, which is the
    ``fault/replan`` verifier gate.
    """
    reduced = reduced_trace(trace, degraded)
    op = OnlinePlanner(reduced.n, r=reduced.r, cm=cm,
                       window=len(reduced.events), fabric=fabric,
                       overlap=overlap, delta_budget=delta_budget,
                       planner=planner, verify=verify)
    # the old-world predictions covering these events were invalidated by
    # the fault: drop them (each counts as a misprediction), then re-predict
    # the same stream on the surviving world and commit it
    op.predict(reduced.events)
    op.drop_predicted(len(reduced.events))
    op.predict(reduced.events)
    for _ in reduced.events:
        op.observe()
    return op.result(name=reduced.name), op.stats()


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """Outcome of one `run_with_recovery` fault-recovery cycle.

    degraded         : the state the fault left the fabric in.
    plan             : the original full-trace plan (old world).
    faulted_run      : the degraded execution that surfaced ``degraded``.
    committed_events : events whose every phase drained before the fault.
    recovery_plan    : re-plan of the remaining events at the reduced n.
    clean_plan       : offline carryover plan of the same reduced trace —
                       the bit-identity reference.
    restart_plan     : the whole trace re-planned from scratch at the
                       reduced n (the no-recovery baseline).
    recovery_total   : resume clock + executed remaining-stream completion.
    restart_total    : resume clock + executed whole-trace completion.
    bit_identical    : recovery schedules == clean schedules AND the two
                       executed completions are exactly equal.
    stats            : the re-planner's counters (the dropped old-world
                       predictions show up as mispredictions).
    """

    degraded: DegradedState
    plan: TracePlan
    faulted_run: TraceFabricResult
    committed_events: tuple[CollectiveEvent, ...]
    recovery_plan: TracePlan
    clean_plan: TracePlan
    restart_plan: TracePlan
    recovery_total: float
    restart_total: float
    bit_identical: bool
    stats: OnlineStats

    @property
    def recovery_ratio(self) -> float:
        """recovery_total / restart_total — <= 1 means resuming from the
        snapshot beats restarting the whole trace (1.0 when the fault struck
        before anything committed and the two coincide)."""
        return self.recovery_total / self.restart_total


def run_with_recovery(trace: Trace, cm: CostModel = PAPER_DEFAULT, *,
                      faults: FaultTimeline,
                      fabric: FabricKind = FabricKind.OCS,
                      overlap: float = 0.0,
                      delta_budget: float | None = None, planner=None,
                      engine_mode: str = "sparse", chunks_per_msg: int = 8,
                      verify: bool = True) -> RecoveryResult:
    """Plan, fault, re-plan, and measure one full recovery cycle.

    Plays the offline carryover plan of ``trace`` under ``faults``, maps the
    surfaced `DegradedState` back to whole events, re-plans the remainder at
    the surviving world size, executes both the recovery plan and the clean
    reduced-world reference on a fresh fabric (bit-identity check), and
    compares resume-from-snapshot against restart-from-scratch.  With
    ``verify=True`` the timeline, the degraded state, and the recovery plan
    must pass the ``fault/*`` verifier rules (`repro_torch.analysis`) — a
    violation raises instead of returning.
    """
    plan = plan_trace(trace, cm, mode="carryover", fabric=fabric,
                      overlap=overlap, delta_budget=delta_budget,
                      planner=planner)
    sim = FabricSim(mode=engine_mode, chunks_per_msg=chunks_per_msg,
                    overlap=overlap)
    faulted = sim.run_trace(plan.fabric_phases(), cm, faults=faults,
                            capture_state=True)
    if faulted.degraded is None:
        raise ValueError(
            "no fault took effect before the trace completed; "
            "FaultTimeline.check_horizon rejects such timelines up front")
    ds = faulted.degraded
    committed, _ = split_events(trace, ds.completed_phases)

    recovery_plan, stats = replan_after_fault(
        trace, ds, cm, fabric=fabric, overlap=overlap,
        delta_budget=delta_budget, planner=planner, verify=verify)
    reduced = reduced_trace(trace, ds)
    clean_plan = plan_trace(reduced, cm, mode="carryover", fabric=fabric,
                            overlap=overlap, delta_budget=delta_budget,
                            planner=planner)
    restart = Trace(name=f"{trace.name}+restart", n=ds.new_n, r=trace.r,
                    events=trace.events)
    restart_plan = plan_trace(restart, cm, mode="carryover", fabric=fabric,
                              overlap=overlap, delta_budget=delta_budget,
                              planner=planner)

    def execute(p: TracePlan) -> float:
        fresh = FabricSim(mode=engine_mode, chunks_per_msg=chunks_per_msg,
                          overlap=overlap)
        return fresh.run_trace(p.fabric_phases(), cm).completion

    recovery_done = execute(recovery_plan)
    clean_done = execute(clean_plan)
    restart_done = execute(restart_plan)
    bit_identical = (recovery_plan.schedules() == clean_plan.schedules()
                     and recovery_done == clean_done)

    result = RecoveryResult(
        degraded=ds, plan=plan, faulted_run=faulted,
        committed_events=committed, recovery_plan=recovery_plan,
        clean_plan=clean_plan, restart_plan=restart_plan,
        recovery_total=ds.resume_clock + recovery_done,
        restart_total=ds.resume_clock + restart_done,
        bit_identical=bit_identical, stats=stats)

    if verify:
        from repro_torch.analysis import (raise_on_violations, verify_degraded,
                                    verify_recovery, verify_timeline)

        found = (verify_timeline(faults)
                 + verify_degraded(ds, phases=plan.fabric_phases(),
                                   chunks_per_msg=chunks_per_msg)
                 + verify_recovery(ds, recovery_plan, clean_plan=clean_plan))
        raise_on_violations(
            found, context=f"fault recovery n={trace.n} "
                           f"kind={ds.fault.kind}")
    return result

"""Receding-horizon online trace planning with fabric-state warm starts.

`plan_trace` is an offline DP: it assumes the whole collective stream is
known up front.  In production serving the stream is only *predicted* —
decode AllGather bursts and MoE All-to-Alls from many jobs arrive one at a
time, predictions beyond a short horizon are unreliable, and the paper's
reconfigure-or-not question becomes a decision under uncertainty.
`OnlinePlanner` is the receding-horizon answer:

  - it sees a sliding window of the next W upcoming `CollectiveEvent`s (the
    realized head plus W-1 predicted followers);
  - it runs the joint (link offset, reconfigs spent) DP over the window
    (`trace_planner.window_dp`) warm-started at the *committed* fabric
    state: the link offset the already-executed collectives left behind is
    the window's initial configuration and entering the window charges the
    sparse changed-circuit diff, exactly as `plan_trace` chains segments;
  - it commits the first event's schedule and advances;
  - it re-plans only when the horizon actually changes — a new event slides
    into the window, a predicted event is substituted by a different one, or
    a predicted event is dropped.  While the realized stream matches the
    predicted one and no new events appear, the stored window plan's suffix
    is committed as-is (so with W >= the remaining stream the planner solves
    the DP once and replays it, making the W=full case bit-identical to the
    offline `plan_trace`).

The committed prefix is never revisited: a misprediction invalidates only
the un-committed window suffix, which is re-planned from the carryover state
(g, spent) the committed prefix established — the same state
`FabricSim.run_trace(..., capture_state=True)` reaches when the committed
schedules are actually played (tests/test_online_planner.py pins this).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Iterable, Sequence

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.jsonio import FabricKind

from .trace_planner import (TRACE_FABRICS, PhaseCandidate, PhasePlan,
                            TracePlan, _finish, _phase_plan, phase_candidates,
                            window_dp)
from .traces import CollectiveEvent, Trace


@dataclasses.dataclass(frozen=True)
class OnlineStats:
    """Counters of one `OnlinePlanner` run.

    commits        : events committed (= phases committed, counting 'ar' once).
    replans        : window DP solves (1 when the window never changed shape).
    plan_reuses    : commits served from the stored window plan without a solve.
    mispredictions : substituted or dropped predicted events observed.
    """

    commits: int
    replans: int
    plan_reuses: int
    mispredictions: int


def _flatten(events: Sequence[CollectiveEvent]) -> list[tuple[str, float, str]]:
    """Flatten events to single-collective phases, `Trace.phases` semantics
    (a composite 'ar' expands to its RS + AG phases)."""
    out: list[tuple[str, float, str]] = []
    for ev in events:
        if ev.kind == "ar":
            out.append(("rs", ev.m_bytes, f"{ev.tag}:rs"))
            out.append(("ag", ev.m_bytes, f"{ev.tag}:ag"))
        else:
            out.append((ev.kind, ev.m_bytes, ev.tag))
    return out


class OnlinePlanner:
    """Receding-horizon planner over a predicted collective stream.

    n, r         : fabric world size and Bruck radix (as in `Trace`).
    window       : horizon W — how many upcoming events (realized head
                   included) each DP solve sees.  W=1 is greedy per-event
                   planning with carryover; W >= the stream length recovers
                   the offline `plan_trace` exactly.
    cm / fabric / overlap / delta_budget : as in `plan_trace`; the budget
                   caps intra-collective reconfiguration stall across the
                   *whole realized stream* (committed spend is carried into
                   every window solve, so the online planner never overspends
                   the trace-wide cap).
    init_g / init_spent : inherited fabric state to warm-start the first
                   window from (e.g. resuming after a fault); None/0 means a
                   fresh fabric, matching the offline planner.
    planner      : a `repro_torch.planner.Planner` (defaults to the process-wide
                   `default_planner()`, sharing its plan cache).
    verify       : statically audit every window DP solution — including
                   warm-started suffix re-plans after a misprediction —
                   before any of it can be committed
                   (`repro_torch.analysis.verify_window_choice`); a corrupt
                   candidate raises `VerificationError` instead of moving
                   the committed (g, spent) fabric-state ledger.

    Drive it with `predict` (append predicted events), `observe` (the next
    event actually arrived — commit its schedule), and `drop_predicted` (a
    predicted event will not arrive).  `result()` assembles the committed
    stream into a `TracePlan` (mode='online').
    """

    def __init__(self, n: int, *, r: int = 2, cm: CostModel = PAPER_DEFAULT,
                 window: int = 4, fabric: FabricKind = FabricKind.OCS,
                 overlap: float = 0.0, tenant: str | None = None,
                 delta_budget: float | None = None, init_g: int | None = None,
                 init_spent: int = 0, planner=None, verify: bool = True):
        if n < 2:
            raise ValueError(f"need at least 2 nodes, got n={n}")
        if r < 2:
            raise ValueError(f"radix must be >= 2, got r={r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        fabric = FabricKind.coerce(fabric)
        if fabric not in TRACE_FABRICS:
            raise ValueError(
                f"fabric must be one of {tuple(map(str, TRACE_FABRICS))}, "
                f"got {str(fabric)!r}")
        if overlap and fabric != FabricKind.OCS_OVERLAP:
            raise ValueError(f"overlap={overlap} requires fabric='ocs-overlap'")
        if delta_budget is not None and delta_budget < 0:
            raise ValueError(f"delta_budget must be >= 0, got {delta_budget}")
        if init_spent < 0:
            raise ValueError(f"init_spent must be >= 0, got {init_spent}")
        if planner is None:
            from repro_torch.planner import default_planner  # deferred: no cycle

            planner = default_planner()
        self.n, self.r = int(n), int(r)
        self.cm, self.fabric, self.overlap = cm, fabric, float(overlap)
        self.tenant = tenant
        self.delta_budget = delta_budget
        self.window = int(window)
        self.planner = planner
        self.verify = bool(verify)
        unit = cm.delta_sparse(n, overlap)
        self._cap: int | None = None
        if delta_budget is not None and unit > 0:
            self._cap = int(delta_budget / unit + 1e-12)
        self._g = init_g                  # fabric state after committed prefix
        self._spent = int(init_spent)     # paid intra reconfigs committed
        self._predicted: deque[CollectiveEvent] = deque()
        self._committed: list[PhasePlan] = []
        self._committed_events: list[CollectiveEvent] = []
        self._plan: list[PhaseCandidate] = []        # un-committed window plan
        self._plan_events: list[CollectiveEvent] = []  # events _plan covers
        self._commits = self._replans = 0
        self._reuses = self._mispred = 0

    # --- introspection -------------------------------------------------------

    @property
    def fabric_state(self) -> int | None:
        """Link offset the committed prefix left the fabric at (None before
        the first commit on a fresh fabric)."""
        return self._g

    @property
    def reconfigs_spent(self) -> int:
        """Paid intra-collective reconfigurations committed so far."""
        return self._spent

    @property
    def committed_events(self) -> tuple[CollectiveEvent, ...]:
        return tuple(self._committed_events)

    @property
    def predicted_events(self) -> tuple[CollectiveEvent, ...]:
        return tuple(self._predicted)

    def stats(self) -> OnlineStats:
        return OnlineStats(commits=self._commits, replans=self._replans,
                           plan_reuses=self._reuses,
                           mispredictions=self._mispred)

    # --- prediction stream ---------------------------------------------------

    def predict(self, events: Iterable[CollectiveEvent]) -> None:
        """Append predicted upcoming events to the stream (lazy: the stored
        window plan is invalidated only when a commit actually sees a
        different window)."""
        for ev in events:
            if not isinstance(ev, CollectiveEvent):
                raise TypeError(f"predict() wants CollectiveEvents, got {ev!r}")
            self._predicted.append(ev)

    def drop_predicted(self, count: int = 1) -> None:
        """The next ``count`` predicted events will not arrive (dropped /
        timed-out predictions).  The committed prefix is untouched; the next
        commit re-plans the shifted window."""
        if count < 1 or count > len(self._predicted):
            raise ValueError(
                f"cannot drop {count} of {len(self._predicted)} predicted "
                f"events")
        for _ in range(count):
            self._predicted.popleft()
        self._mispred += count

    # --- commit loop ---------------------------------------------------------

    def observe(self, event: CollectiveEvent | None = None
                ) -> tuple[PhasePlan, ...]:
        """The next collective actually arrived; commit its schedule(s).

        ``event=None`` asserts the predicted head arrived exactly as
        predicted.  Passing a different event records a substitution
        misprediction: the stored window plan is discarded and the realized
        window — the arrived event plus the surviving predictions — is
        re-planned from the committed fabric state.  Returns the committed
        phase plans (one, or the RS + AG pair for an 'ar' event).
        """
        if event is None:
            if not self._predicted:
                raise ValueError(
                    "no predicted events left; pass the realized event "
                    "explicitly (or predict() more)")
            event = self._predicted.popleft()
        elif self._predicted:
            if self._predicted[0] == event:
                self._predicted.popleft()
            else:
                self._predicted.popleft()  # substituted prediction
                self._mispred += 1
        else:
            self._mispred += 1  # unpredicted arrival
        window = [event] + list(itertools.islice(self._predicted,
                                                 self.window - 1))
        if self._plan_events != window:
            self._solve(window)
        else:
            self._reuses += 1
        committed = []
        phases = _flatten([event])
        for (kind, m, tag), cand in zip(phases, self._plan, strict=False):
            committed.append(_phase_plan(kind, m, tag, cand))
            self._g = cand.g_last
            self._spent += cand.paid
        del self._plan[:len(phases)]
        del self._plan_events[0]
        self._committed.extend(committed)
        self._committed_events.append(event)
        self._commits += 1
        return tuple(committed)

    def _solve(self, window: list[CollectiveEvent]) -> None:
        """Joint DP over the window, warm-started at the committed state."""
        phases = _flatten(window)
        cand_lists = [
            phase_candidates(kind, self.n, self.r, m, self.cm, self.fabric,
                             self.overlap, self.planner, tenant=self.tenant)
            for kind, m, _ in phases]
        self._plan = window_dp(
            self.n, cand_lists, self.cm, overlap=self.overlap,
            init_g=self._g, init_spent=self._spent, cap=self._cap,
            label=f"{len(window)}-event window")
        if self.verify:
            # audit-before-commit: the suffix re-plan is checked against the
            # committed (g, spent) ledger before any of it moves that ledger
            from repro_torch.analysis import raise_on_violations, verify_window_choice

            raise_on_violations(
                verify_window_choice(
                    self.n, self._plan, init_spent=self._spent,
                    cap=self._cap, label=f"{len(window)}-event window"),
                context=f"online window n={self.n}")
        self._plan_events = list(window)
        self._replans += 1

    # --- results -------------------------------------------------------------

    def result(self, name: str = "online") -> TracePlan:
        """Committed stream as a `TracePlan` (mode='online').

        Boundary accounting and the total-time summation follow `_finish`
        exactly, so an online run that committed the same schedules as the
        offline DP reports bit-identical totals.  The entry boundary of a
        warm-started planner (``init_g``) is outside the committed stream
        and not included.
        """
        if not self._committed:
            raise ValueError("nothing committed yet")
        trace = Trace(name=name, n=self.n, r=self.r,
                      events=tuple(self._committed_events))
        return _finish(trace, "online", self.fabric, self.overlap,
                       self.delta_budget, self.cm, list(self._committed),
                       full_boundaries=False)


def run_online(trace: Trace, cm: CostModel = PAPER_DEFAULT, *,
               window: int = 4, fabric: str = "ocs", overlap: float = 0.0,
               delta_budget: float | None = None, planner=None,
               realized: Sequence[CollectiveEvent] | None = None
               ) -> tuple[TracePlan, OnlineStats]:
    """Drive an `OnlinePlanner` over ``trace`` and return (plan, stats).

    The trace's events are the predicted stream.  ``realized`` (default: the
    predictions come true) substitutes the actually-arriving events — same
    length or shorter; a shorter realized stream leaves the prediction tail
    unobserved.  This is the benchmark harness path (`benchmarks/
    online_bench.py`) and the regret-test entry point.
    """
    op = OnlinePlanner(trace.n, r=trace.r, cm=cm, window=window,
                       fabric=fabric, overlap=overlap,
                       delta_budget=delta_budget, planner=planner)
    op.predict(trace.events)
    if realized is None:
        for _ in trace.events:
            op.observe()
    else:
        for ev in realized:
            op.observe(ev)
    return op.result(name=trace.name), op.stats()

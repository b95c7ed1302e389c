"""The unified Planner: one entry point for all four collectives.

A copy of `repro.planner.planner` for the port.  ``ocs-sim`` scoring plays
its candidates on the card's batch engine (``sim_backend="torch"``, kernel
B6) in place of the reference's JAX one.

Evaluates every candidate from the selected strategy families under the
request's cost model and fabric, ranks them by the request's objective, and
returns a `PlanResult` with the winner, its full `TimeBreakdown`, and the
ranked alternatives table.

Fabrics and scoring:

  - ``ocs`` / ``static`` / ``ocs-overlap`` score analytically
    (`core.simulator`), exactly as before.
  - ``ocs-sim`` event-scores *every* candidate with the vectorized batch
    fabric engine (`core.batchsim.batch_completion_times`) in a single
    batched call — per-port queueing, chunk pipelining, and sparse
    reconfiguration stalls that the closed-form model cannot see.  The
    winner is the candidate the simulator ranks fastest, so it is never a
    schedule the simulator would rank worse than the analytic winner (which
    is always in the candidate set).  The scoring call picks the card's
    playback (the CUDA kernel B6) automatically when a CUDA device is
    present and the candidate set is large enough to amortize it
    (``sim_backend="auto"``), and the NumPy engine otherwise — scores are
    identical either way.  ``predicted_time`` and the
    alternatives' scores are simulated completions; ``breakdown`` stays the
    analytic sparse-delta decomposition for reporting.  Non-Bruck
    implementation candidates (the ring baseline) keep their analytic score
    when explicitly selected.

Serving path: every `Planner` carries an LRU plan cache keyed by the
canonical JSON of the request (`cache_size` entries, hit/miss counters via
`cache_info`), so repeated traffic gets an amortized-O(1) answer, and
`plan_batch` plans a whole request list through the cache in one call.  Use
`default_planner()` for a process-wide shared instance (the
`core.schedules.plan` and `collectives.plan_gradient_sync` shims route
through it).  Mutating the strategy registry invalidates cached plans —
call `cache_clear()` after registering/unregistering strategies.

The composite AllReduce (`kind='ar'`) follows the Rabenseifner
decomposition the paper evaluates: the RS and AG phases are planned
independently (each over the schedule-producing strategies), combined by
`core.simulator.allreduce_time` (which charges the RS->AG topology
transition), and compared against implementation-level alternatives such as
the ring baseline when one is selected (ring registers with default=False;
name it in `PlanRequest.strategies`, as `plan_gradient_sync` does).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import NamedTuple, Sequence

from repro_torch.analysis import raise_on_violations, verify_plan
from repro_torch.core import baselines
from repro_torch.core.batchsim import batch_completion_times
from repro_torch.core.schedules import Schedule, changed_links, static_schedule
from repro_torch.core.simulator import (TimeBreakdown, allreduce_time,
                                  allreduce_time_overlap, collective_time,
                                  collective_time_overlap)

from .api import (Candidate, FabricKind, PlanRequest, PlanResult,
                  RankedAlternative)
from .registry import select_strategies


def _objective_score(bd: TimeBreakdown, objective: str) -> float:
    if objective == "time":
        return bd.total
    if objective == "latency":
        return bd.startup + bd.hop_latency + bd.reconfig
    return bd.transmission + bd.reconfig  # "transmission"


class PlanCacheInfo(NamedTuple):
    """Hit/miss counters of one Planner's LRU plan cache."""

    hits: int
    misses: int
    size: int
    capacity: int


class Planner:
    """Plans any of a2a / rs / ag / ar via the strategy registry.

    cache_size : LRU plan-cache capacity (0 disables caching; results are
                 immutable `PlanResult`s, safe to share between callers).
    sim_chunks : chunks per message used by the ``ocs-sim`` event scoring
                 (the batch engine's MTU-like pipelining knob).
    sim_backend: batch-engine backend for ``ocs-sim`` scoring —
                 ``"auto"`` (default: the card's playback when a CUDA
                 device is present and the candidate set is large enough to
                 amortize it, NumPy otherwise), ``"numpy"``, or ``"torch"``
                 (the card; raises without one).  Scores are identical
                 across backends (the CUDA kernel is bit-compatible on
                 certified lanes); only wall time changes.
    verify     : statically verify every freshly-planned result
                 (`repro_torch.analysis.verify_plan`) *before* it enters the plan
                 cache — a corrupt plan raises `VerificationError` instead
                 of being cached and served to every later hit.  Cache hits
                 are returns of already-verified objects and are not
                 re-checked, so the serving hot path is unaffected.

    Candidate generation reuses the memoized all-R DP tables in
    `core.schedules` and the compiled schedule tapes in `core.batchsim`, so
    repeated planning at the same (n, r) is cheap even on cache misses.
    """

    def __init__(self, *, cache_size: int = 128, sim_chunks: int = 8,
                 sim_backend: str = "auto", verify: bool = True):
        if cache_size < 0:
            raise ValueError(f"cache_size must be >= 0, got {cache_size}")
        if sim_backend not in ("auto", "numpy", "torch"):
            raise ValueError(
                f"sim_backend must be 'auto', 'numpy', or 'torch', "
                f"got {sim_backend!r}")
        self.cache_size = int(cache_size)
        self.sim_chunks = max(1, int(sim_chunks))
        self.sim_backend = sim_backend
        self.verify = bool(verify)
        self._cache: collections.OrderedDict[str, PlanResult] = \
            collections.OrderedDict()
        self._hits = 0
        self._misses = 0

    # --- cached serving path -------------------------------------------------

    @staticmethod
    def cache_key(req: PlanRequest) -> str:
        """Canonical JSON identity of a request (the plan-cache key).

        Includes the inherited fabric state (``init_g``): two windowed
        requests that are otherwise identical but enter from different link
        configurations are different planning problems and must never share
        a cache entry.
        """
        return json.dumps(req.to_dict(), sort_keys=True)

    def cache_info(self) -> PlanCacheInfo:
        return PlanCacheInfo(hits=self._hits, misses=self._misses,
                             size=len(self._cache), capacity=self.cache_size)

    def cache_clear(self) -> None:
        self._cache.clear()
        self._hits = 0
        self._misses = 0

    def plan(self, req: PlanRequest) -> PlanResult:
        if self.cache_size == 0:
            return self._verified(self._plan_uncached(req))
        key = self.cache_key(req)
        hit = self._cache.get(key)
        if hit is not None:
            self._hits += 1
            self._cache.move_to_end(key)
            return hit
        self._misses += 1
        # verify-before-cache: a result that fails static verification must
        # never be cached, or every later hit would serve the corruption
        res = self._verified(self._plan_uncached(req))
        self._cache[key] = res
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return res

    def _verified(self, res: PlanResult) -> PlanResult:
        if self.verify:
            raise_on_violations(
                verify_plan(res),
                context=f"plan({res.request.kind}, n={res.request.n})")
        return res

    def plan_batch(self, requests: Sequence[PlanRequest]) -> tuple[PlanResult, ...]:
        """Plan every request, deduplicating repeats through the plan cache.

        Returns results aligned with ``requests``; identical requests are
        planned once (the serving path's amortized-O(1) answer for repeated
        traffic).
        """
        return tuple(self.plan(req) for req in requests)

    def _plan_uncached(self, req: PlanRequest) -> PlanResult:
        if req.kind == "ar":
            return self._plan_allreduce(req)
        return self._plan_collective(req)

    # --- single collectives --------------------------------------------------

    def _candidates(self, req: PlanRequest, kind: str):
        max_R = req.effective_max_R()
        for si in select_strategies(req, kind):
            for cand in si.fn(req, kind):
                sched = cand.schedule
                if sched is not None:
                    if max_R is not None and sched.R > max_R:
                        continue
                    if req.fabric == FabricKind.STATIC and sched.R > 0:
                        continue  # no OCS to rewire mid-collective
                yield cand

    def _evaluate(self, req: PlanRequest, kind: str, cand: Candidate) -> TimeBreakdown:
        if cand.impl == "ring":
            return baselines.ring(kind, req.n, req.m_bytes, req.cost_model)
        assert cand.schedule is not None
        if req.fabric in (FabricKind.OCS_OVERLAP, FabricKind.OCS_SIM):
            # for ocs-sim this is the reported analytic decomposition; the
            # score itself comes from the batched event simulation
            return collective_time_overlap(cand.schedule, req.m_bytes,
                                           req.cost_model, req.overlap,
                                           ports=req.ports)
        return collective_time(cand.schedule, req.m_bytes, req.cost_model,
                               ports=req.ports)

    @staticmethod
    def _entry_cost(req: PlanRequest, sched: Schedule | None) -> float:
        """Sparse boundary cost of entering ``sched`` from the inherited
        fabric state (0 when the request carries no ``init_g``, and for the
        ring implementation, whose fixed topology the carryover model does
        not cover)."""
        if req.init_g is None or sched is None:
            return 0.0
        return req.cost_model.delta_sparse(
            changed_links(req.n, req.init_g, sched.link_offsets()[0]),
            req.overlap)

    def _sim_scores(self, req: PlanRequest,
                    cands: list[Candidate]) -> dict[int, float]:
        """Batched event scores for every schedule candidate (ocs-sim)."""
        idx = [i for i, c in enumerate(cands) if c.schedule is not None]
        if not idx:
            return {}
        completions = batch_completion_times(
            [cands[i].schedule for i in idx], req.m_bytes, req.cost_model,
            overlap=req.overlap, chunks_per_msg=self.sim_chunks,
            backend=self.sim_backend)
        return {i: float(t) for i, t in zip(idx, completions, strict=True)}

    def _plan_collective(self, req: PlanRequest) -> PlanResult:
        cands: list[Candidate] = []
        seen_x: set[tuple[int, ...]] = set()
        for cand in self._candidates(req, req.kind):
            # families overlap at the endpoints (static == periodic(R=0),
            # every-step == periodic(R=S-1)); evaluate each schedule once,
            # first-registered family keeps the name
            if cand.schedule is not None:
                if cand.schedule.x in seen_x:
                    continue
                seen_x.add(cand.schedule.x)
            cands.append(cand)
        if not cands:
            raise ValueError(
                f"no strategy produced a candidate for {req.kind} "
                f"(strategies={req.strategies}, constraints may be infeasible)")
        sim_scores = (self._sim_scores(req, cands)
                      if req.fabric == FabricKind.OCS_SIM else {})

        best: tuple[float, Candidate, TimeBreakdown, float] | None = None
        ranked: list[RankedAlternative] = []
        for i, cand in enumerate(cands):
            bd = self._evaluate(req, req.kind, cand)
            entry = self._entry_cost(req, cand.schedule)
            if i in sim_scores:
                score = predicted = sim_scores[i] + entry
            else:
                score = _objective_score(bd, req.objective) + entry
                predicted = bd.total + entry
            sched = cand.schedule
            ranked.append(RankedAlternative(
                strategy=cand.name, impl=cand.impl, predicted_time=predicted,
                score=score, R=sched.R if sched is not None else None,
                x=sched.x if sched is not None else None))
            if best is None or score < best[0]:
                best = (score, cand, bd, predicted)
        assert best is not None
        _, cand, bd, predicted = best
        ranked.sort(key=lambda a: a.score)
        return PlanResult(
            request=req, strategy=cand.name, impl=cand.impl,
            predicted_time=predicted, breakdown=bd, schedule=cand.schedule,
            alternatives=tuple(ranked))

    # --- composite AllReduce -------------------------------------------------

    def _allreduce_bd(self, req: PlanRequest, rs_sched: Schedule,
                      ag_sched: Schedule) -> TimeBreakdown:
        """Combined RS+AG breakdown under the request's fabric semantics."""
        if req.fabric in (FabricKind.OCS_OVERLAP, FabricKind.OCS_SIM):
            return allreduce_time_overlap(rs_sched, ag_sched, req.m_bytes,
                                          req.cost_model, req.overlap,
                                          ports=req.ports)
        return allreduce_time(rs_sched, ag_sched, req.m_bytes,
                              req.cost_model, ports=req.ports)

    def _allreduce_score(self, req: PlanRequest, rs_res: PlanResult,
                         ag_res: PlanResult,
                         bd: TimeBreakdown) -> float:
        """Objective score of one RS+AG split.

        Under ``ocs-sim`` the phases' predicted times are already simulated
        completions; the RS->AG topology transition is charged as a sparse
        swap exactly as `allreduce_time_overlap` does.
        """
        if req.fabric != FabricKind.OCS_SIM:
            return _objective_score(bd, req.objective)
        rs_final = rs_res.schedule.link_offsets()[-1]
        ag_first = ag_res.schedule.link_offsets()[0]
        changed = req.n if rs_final != ag_first else 0
        transition = req.cost_model.delta_sparse(changed, req.overlap)
        return rs_res.predicted_time + ag_res.predicted_time + transition

    def _plan_rs_ag_phases(self, req: PlanRequest,
                           sched_names: tuple[str, ...] | None
                           ) -> tuple[PlanResult, PlanResult]:
        """Plan the RS and AG phases of an 'ar' request.

        Unconstrained, the phases are independent.  A reconfiguration cap
        (max_R / delta_budget) applies to the *whole* AllReduce, so the cap
        is split across the phases and the best split wins (cf.
        `baselines.bridge_allreduce_fixed_R`); the RS->AG transition delta
        charged by `allreduce_time` is topology-dependent and not counted
        against the cap.
        """

        def sub(kind: str, cap: int | None) -> PlanResult:
            # init_g is stripped: the entry boundary is charged once at the
            # composite level (on the chosen RS schedule), not per phase
            return self._plan_collective(dataclasses.replace(
                req, kind=kind, strategies=sched_names,
                max_R=cap, delta_budget=None, init_g=None))

        total_cap = req.effective_max_R()
        if total_cap is None:
            return sub("rs", None), sub("ag", None)
        best: tuple[float, PlanResult, PlanResult] | None = None
        for k in range(total_cap + 1):
            rs_res = sub("rs", k)
            ag_res = sub("ag", total_cap - k)
            bd = self._allreduce_bd(req, rs_res.schedule, ag_res.schedule)
            score = self._allreduce_score(req, rs_res, ag_res, bd)
            if best is None or score < best[0]:
                best = (score, rs_res, ag_res)
        assert best is not None
        return best[1], best[2]

    def _plan_allreduce(self, req: PlanRequest) -> PlanResult:
        names = req.strategies
        sched_names = (None if names is None
                       else tuple(nm for nm in names if nm != "ring"))
        want_bruck = sched_names is None or len(sched_names) > 0
        want_ring = names is not None and "ring" in names

        evaluated: list[tuple[str, str, float, float, TimeBreakdown,
                              Schedule | None, Schedule | None]] = []
        if want_bruck:
            rs_res = ag_res = None
            if req.fabric != FabricKind.STATIC:
                rs_res, ag_res = self._plan_rs_ag_phases(req, sched_names)
                rs_sched, ag_sched = rs_res.schedule, ag_res.schedule
                name = f"bruck[{rs_res.strategy} + {ag_res.strategy}]"
            else:
                # static fabric: hardware routes each Bruck offset directly;
                # cost with the R=0 model (DESIGN.md S3).
                rs_sched = static_schedule("rs", req.n, req.r)
                ag_sched = static_schedule("ag", req.n, req.r)
                name = "bruck[static]"
            assert rs_sched is not None and ag_sched is not None
            bd = self._allreduce_bd(req, rs_sched, ag_sched)
            entry = self._entry_cost(req, rs_sched)
            if req.fabric == FabricKind.OCS_SIM:
                score = predicted = (
                    self._allreduce_score(req, rs_res, ag_res, bd) + entry)
            else:
                score = _objective_score(bd, req.objective) + entry
                predicted = bd.total + entry
            evaluated.append((name, "bruck", score, predicted, bd,
                              rs_sched, ag_sched))
        if want_ring:
            bd = baselines.ring("ar", req.n, req.m_bytes, req.cost_model)
            evaluated.append(("ring", "ring",
                              _objective_score(bd, req.objective), bd.total,
                              bd, None, None))
        if not evaluated:
            raise ValueError(
                f"no strategy produced an AllReduce candidate "
                f"(strategies={req.strategies})")

        evaluated.sort(key=lambda e: e[2])
        name, impl, _, predicted, bd, rs_sched, ag_sched = evaluated[0]
        ranked = tuple(
            RankedAlternative(strategy=nm, impl=im, predicted_time=pt,
                              score=sc, R=(rs.R + ag.R) if rs and ag else None)
            for nm, im, sc, pt, b, rs, ag in evaluated)
        return PlanResult(
            request=req, strategy=name, impl=impl, predicted_time=predicted,
            breakdown=bd, rs_schedule=rs_sched, ag_schedule=ag_sched,
            alternatives=ranked)


_DEFAULT_PLANNER: Planner | None = None


def default_planner() -> Planner:
    """Process-wide shared Planner (the cached plan-serving path)."""
    global _DEFAULT_PLANNER
    if _DEFAULT_PLANNER is None:
        _DEFAULT_PLANNER = Planner()
    return _DEFAULT_PLANNER

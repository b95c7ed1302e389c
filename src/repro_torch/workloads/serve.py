"""Plan-serving front-end: windowed plan requests answered through an LRU.

The serving-fleet picture (PCCL-style): many jobs share one reconfigurable
fabric, each periodically asking "here is my visible window of upcoming
collectives and the link offset my last collective left behind — what should
I run?".  `PlanService` answers such `ServeRequest`s in two tiers:

  - cache hit : the canonical JSON of the request (events + fabric carryover
    state) indexes a serving LRU of finished `ServedPlan`s — the
    microsecond-scale path repeated traffic takes;
  - cache miss: the request falls through to the receding-horizon machinery —
    the window's phases are candidate-tabled through the shared `Planner`
    (its own LRU amortizes the per-phase tables across jobs and windows) and
    joined by `trace_planner.window_dp`, warm-started at the request's
    ``init_g`` exactly like the online planner's re-plan step.

The request key includes ``init_g`` for the same reason `Planner.cache_key`
does: two windows with identical events but different inherited link offsets
are different planning problems, and a stale hit would hand one job a plan
whose entry boundary was priced for another job's fabric state.

`request_storm` is the synthetic driver: a seeded, skew-weighted storm of
windowed requests (hot windows repeat, cold ones churn) measuring plans/sec
and hit rate, with a timing-independent signature over the served plan
sequence so determinism is testable (benchmarks/online_bench.py gates the
cache-hit throughput floor; tests/test_serving.py pins determinism and the
never-worse-than-cold property).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
from collections import OrderedDict
from typing import NamedTuple, Sequence

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.jsonio import FabricKind, RequestBase, require_keys
from repro_torch.core.schedules import changed_links

from .trace_planner import (TRACE_FABRICS, PhasePlan, phase_candidates,
                            window_dp)
from .traces import (CollectiveEvent, decode_ag_trace, mixed_trace,
                     moe_a2a_trace)


class ServeCacheInfo(NamedTuple):
    """Serving-LRU counters, extended with the degraded-mode retry ledger.

    hits / misses / size / capacity mirror `planner.PlanCacheInfo`;
    retries counts cache-bypass re-plans after a `VerificationError`, and
    retry_failures counts requests whose retry budget was exhausted (the
    error then propagates to the caller).
    """

    hits: int
    misses: int
    retries: int
    retry_failures: int
    size: int
    capacity: int


@dataclasses.dataclass(frozen=True)
class ServeRequest(RequestBase):
    """One job's windowed plan request.

    events : the job's visible window of upcoming collectives (>= 1).
    n, r   : fabric world size and Bruck radix.
    init_g : link offset the job's previous collective left the fabric at
             (None = fresh fabric, no entry boundary).
    tenant : requesting tenant's identity (multi-tenant serving).  Part of
             the request key: two tenants with identical windows must never
             share a cached `ServedPlan` (same stale-hit class as init_g —
             a tenant's entry may be priced for another tenant's state).
    """

    events: tuple[CollectiveEvent, ...]
    n: int
    r: int = 2
    init_g: int | None = None
    tenant: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if not self.events:
            raise ValueError("a serve request needs at least one event")
        self._validate_base()

    def to_dict(self) -> dict:
        return {"events": [ev.to_dict() for ev in self.events],
                "n": self.n, "r": self.r, "init_g": self.init_g,
                "tenant": self.tenant}

    @classmethod
    def from_dict(cls, d: dict) -> "ServeRequest":
        require_keys(d, required=("events", "n"),
                     optional=("r", "init_g", "tenant"), what="ServeRequest")
        init_g = d.get("init_g")
        if init_g is not None and not 1 <= init_g < d["n"]:
            raise ValueError(
                f"ServeRequest init_g must be a link offset in [1, n), got "
                f"init_g={init_g} with n={d['n']}")
        return ServeRequest(
            events=tuple(CollectiveEvent.from_dict(e) for e in d["events"]),
            n=d["n"], r=d.get("r", 2), init_g=init_g,
            tenant=d.get("tenant"))


@dataclasses.dataclass(frozen=True)
class ServedPlan:
    """Outcome of one served window.

    phases        : planned single-collective phases ('ar' events expanded).
    entry_changed / entry_cost : circuits rewired (and sparse stall paid)
                    entering the window from the request's ``init_g``.
    boundary_changed / boundary_cost : per intra-window boundary, as in
                    `TracePlan`.
    total_time    : entry + phase times + boundary costs (the quantity
                    `window_dp` minimizes).
    final_g       : link offset the window leaves the fabric at (the
                    ``init_g`` of the job's next request).
    """

    request: ServeRequest
    phases: tuple[PhasePlan, ...]
    entry_changed: int
    entry_cost: float
    boundary_changed: tuple[int, ...]
    boundary_cost: tuple[float, ...]
    total_time: float
    final_g: int

    @property
    def paid_reconfigs(self) -> int:
        return sum(p.paid_reconfigs for p in self.phases)

    def to_dict(self) -> dict:
        return {
            "request": self.request.to_dict(),
            "phases": [p.to_dict() for p in self.phases],
            "entry_changed": self.entry_changed,
            "entry_cost": self.entry_cost,
            "boundary_changed": list(self.boundary_changed),
            "boundary_cost": list(self.boundary_cost),
            "total_time": self.total_time, "final_g": self.final_g,
        }


class PlanService:
    """Serving front-end over the windowed-plan LRU + window DP (see module
    docstring).

    cm / fabric / overlap : planning model shared by every served window.
    cache_size : serving-LRU capacity (entries are immutable `ServedPlan`s).
    planner    : the shared `repro_torch.planner.Planner` the candidate tables go
                 through (defaults to the process-wide `default_planner()`).
    verify     : statically audit every freshly-planned window
                 (`repro_torch.analysis.verify_served_plan`) before it is cached
                 or served — a corrupt window raises `VerificationError`
                 instead of becoming a production incident on every later
                 cache hit.  Hits return already-audited plans unchecked.
    max_retries / retry_backoff_s : degraded-mode serving.  A window that
                 fails its audit is re-planned up to ``max_retries`` times
                 with the shared planner LRU cleared first (cache bypass —
                 a poisoned candidate table would otherwise be replayed
                 verbatim), sleeping ``retry_backoff_s * 2**attempt`` between
                 tries; only an exhausted budget lets the
                 `VerificationError` reach the caller.  The retry ledger is
                 surfaced in `cache_info`.
    """

    def __init__(self, *, cm: CostModel = PAPER_DEFAULT,
                 fabric: FabricKind = FabricKind.OCS,
                 overlap: float = 0.0, cache_size: int = 512, planner=None,
                 verify: bool = True, max_retries: int = 1,
                 retry_backoff_s: float = 0.0):
        fabric = FabricKind.coerce(fabric)
        if fabric not in TRACE_FABRICS:
            raise ValueError(
                f"fabric must be one of {tuple(map(str, TRACE_FABRICS))}, "
                f"got {str(fabric)!r}")
        if overlap and fabric != FabricKind.OCS_OVERLAP:
            raise ValueError(f"overlap={overlap} requires fabric='ocs-overlap'")
        if cache_size < 0:
            raise ValueError(f"cache_size must be >= 0, got {cache_size}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        if planner is None:
            from repro_torch.planner import default_planner  # deferred: no cycle

            planner = default_planner()
        self.cm, self.fabric, self.overlap = cm, fabric, float(overlap)
        self.cache_size = int(cache_size)
        self.planner = planner
        self.verify = bool(verify)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._cache: OrderedDict[str, ServedPlan] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._retries = 0
        self._retry_failures = 0

    # --- cache ---------------------------------------------------------------

    @staticmethod
    def request_key(req: ServeRequest) -> str:
        """Canonical JSON identity of a request (includes ``init_g``: same
        window, different inherited fabric state -> different entry)."""
        return json.dumps(req.to_dict(), sort_keys=True)

    def cache_info(self) -> ServeCacheInfo:
        return ServeCacheInfo(hits=self._hits, misses=self._misses,
                              retries=self._retries,
                              retry_failures=self._retry_failures,
                              size=len(self._cache), capacity=self.cache_size)

    def cache_clear(self) -> None:
        self._cache.clear()
        self._hits = 0
        self._misses = 0
        self._retries = 0
        self._retry_failures = 0

    # --- serving -------------------------------------------------------------

    def serve(self, req: ServeRequest) -> ServedPlan:
        if self.cache_size == 0:
            return self._plan_with_retry(req)
        key = self.request_key(req)
        hit = self._cache.get(key)
        if hit is not None:
            self._hits += 1
            self._cache.move_to_end(key)
            return hit
        self._misses += 1
        plan = self._plan_with_retry(req)
        self._cache[key] = plan
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return plan

    def serve_batch(self, reqs: Sequence[ServeRequest]) -> tuple[ServedPlan, ...]:
        return tuple(self.serve(req) for req in reqs)

    def _plan_with_retry(self, req: ServeRequest) -> ServedPlan:
        """Degraded-mode miss path: bounded retry with cache bypass.

        A `VerificationError` from the audit marks the freshly-planned
        window corrupt; instead of failing the request outright the shared
        planner LRU is cleared (the corrupt candidate tables must not be
        replayed) and the window re-planned, up to ``max_retries`` times
        with exponential backoff.  Only an exhausted budget re-raises.
        """
        from repro_torch.analysis import VerificationError, clear_verifier_caches

        for attempt in range(self.max_retries + 1):
            try:
                return self._plan_window(req)
            except VerificationError:
                if attempt == self.max_retries:
                    self._retry_failures += 1
                    raise
                self._retries += 1
                if self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s * (2.0 ** attempt))
                self.planner.cache_clear()
                clear_verifier_caches()
        raise AssertionError("unreachable: retry loop returns or raises")

    def _plan_window(self, req: ServeRequest) -> ServedPlan:
        """Cache-miss path: window DP warm-started at the request's init_g."""
        from .online_planner import _flatten
        from .trace_planner import _phase_plan

        phases = _flatten(req.events)
        cand_lists = [
            phase_candidates(kind, req.n, req.r, m, self.cm, self.fabric,
                             self.overlap, self.planner, tenant=req.tenant)
            for kind, m, _ in phases]
        chosen = window_dp(req.n, cand_lists, self.cm, overlap=self.overlap,
                           init_g=req.init_g,
                           label=f"{len(req.events)}-event serve window")
        plans = [_phase_plan(kind, m, tag, cand)
                 for (kind, m, tag), cand in zip(phases, chosen, strict=True)]
        entry_changed = (0 if req.init_g is None else
                         changed_links(req.n, req.init_g, chosen[0].g_first))
        entry_cost = self.cm.delta_sparse(entry_changed, self.overlap)
        boundary_changed, boundary_cost = [], []
        for prev, nxt in zip(chosen, chosen[1:], strict=False):
            bc = changed_links(req.n, prev.g_last, nxt.g_first)
            boundary_changed.append(bc)
            boundary_cost.append(self.cm.delta_sparse(bc, self.overlap))
        total = (entry_cost + sum(p.time for p in plans)
                 + sum(boundary_cost))
        plan = ServedPlan(
            request=req, phases=tuple(plans),
            entry_changed=entry_changed, entry_cost=entry_cost,
            boundary_changed=tuple(boundary_changed),
            boundary_cost=tuple(boundary_cost), total_time=total,
            final_g=chosen[-1].g_last)
        if self.verify:
            # audit-before-serve: runs on the cache-miss path only, so the
            # hot hit path stays microsecond-scale
            from repro_torch.analysis import raise_on_violations, verify_served_plan

            raise_on_violations(
                verify_served_plan(plan, self.cm, self.overlap),
                context=f"serve window n={req.n} ({len(req.events)} events)")
        return plan


# --- synthetic request storm --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StormResult:
    """Outcome of one `request_storm` run.

    signature is a sha256 over the served plan sequence (requests + chosen
    schedules + modeled totals) — independent of wall time, so two storms
    with the same seed and pool must produce equal signatures regardless of
    machine speed.
    """

    requests: int
    hits: int
    misses: int
    unique_windows: int
    wall_s: float
    plans_per_sec: float
    hit_rate: float
    signature: str


def build_request_pool(n: int, *, r: int = 2, window: int = 3, seed: int = 0
                       ) -> tuple[ServeRequest, ...]:
    """Deterministic pool of windowed requests sliced from the workload
    generators: every length-``window`` slice of a decode burst, an MoE
    layer stream, and a mixed trace, crossed with a few inherited fabric
    states (fresh, unit offset, a mid-range offset)."""
    traces = [
        decode_ag_trace(n, decode_steps=8, seed=seed, jitter=0.25),
        moe_a2a_trace(n, layers=3, seed=seed),
        mixed_trace(n, seed=seed),
    ]
    init_gs: tuple[int | None, ...] = (None, 1, max(2, n // 4))
    pool = []
    for t in traces:
        for i in range(0, max(1, len(t.events) - window + 1)):
            evs = t.events[i:i + window]
            if not evs:
                continue
            for g in init_gs:
                pool.append(ServeRequest(events=evs, n=n, r=r, init_g=g))
    return tuple(pool)


def request_storm(service: PlanService, pool: Sequence[ServeRequest], *,
                  requests: int = 512, seed: int = 0,
                  hot_fraction: float = 0.25) -> StormResult:
    """Fire a seeded storm of ``requests`` draws from ``pool`` at the service.

    Draws are skew-weighted (Zipf-like 1/(rank+1) over a seeded shuffle of
    the pool, so roughly ``hot_fraction`` of the pool serves most traffic —
    the repeated-window regime the serving LRU exists for).  Returns
    plans/sec, hit accounting deltas for this storm, and the deterministic
    plan-sequence signature.
    """
    if not pool:
        raise ValueError("request_storm needs a non-empty pool")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    if not 0.0 < hot_fraction <= 1.0:
        raise ValueError(f"hot_fraction must be in (0, 1], got {hot_fraction}")
    rng = random.Random(seed)
    ranks = list(range(len(pool)))
    rng.shuffle(ranks)
    # Zipf-ish: the first ~hot_fraction of the shuffled pool gets most draws
    weights = [1.0 / (1.0 + rank / max(1.0, hot_fraction * len(pool)))
               for rank in ranks]
    order = rng.choices(range(len(pool)), weights=weights, k=requests)

    hits0, misses0 = service._hits, service._misses
    t0 = time.perf_counter()
    served = [service.serve(pool[i]) for i in order]
    wall = time.perf_counter() - t0
    hits = service._hits - hits0
    misses = service._misses - misses0

    digest = hashlib.sha256()
    for plan in served:
        digest.update(json.dumps(plan.to_dict(), sort_keys=True).encode())
    return StormResult(
        requests=requests, hits=hits, misses=misses,
        unique_windows=len(set(order)), wall_s=wall,
        plans_per_sec=requests / wall if wall > 0 else float("inf"),
        hit_rate=hits / requests, signature=digest.hexdigest())

"""Planner API surface: PlanRequest -> Planner -> PlanResult.

`PlanRequest` describes *what* to plan (collective kind — including the
composite AllReduce ``ar`` = RS + AG —, world size, radix, payload, cost
model, fabric, objective, constraints) and optionally *how* (an explicit
strategy subset from the registry).  `PlanResult` carries the winning
schedule(s), the full `TimeBreakdown`, a ranked table of every evaluated
alternative, and lossless JSON (de)serialization so plans can be cached on
disk and shipped as benchmark artifacts.

All floats survive the JSON round trip bit-exactly (json uses repr), and
schedules are plain (kind, n, x, r) tuples, so
``PlanResult.from_json(res.to_json())`` reconstructs bit-identical schedules.

Fabrics are selected with the typed `FabricKind` enum (re-exported here from
`core.jsonio` together with the multi-tenant `SharingMode`); bare strings
like ``fabric="ocs"`` keep working through a coercion shim but emit a
`DeprecationWarning` — new call sites should write
``fabric=FabricKind.OCS``.  JSON loaders round-trip the enums losslessly
(`to_dict` stores the plain value, `from_dict` re-coerces silently).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Literal

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.jsonio import (FabricKind, RequestBase, SharingMode,
                               cost_model_from_dict, cost_model_to_dict,
                               require_keys, require_positive_payload)
from repro_torch.core.schedules import Schedule
from repro_torch.core.simulator import TimeBreakdown

PlanKind = Literal["a2a", "rs", "ag", "ar"]
PLAN_KINDS = ("a2a", "rs", "ag", "ar")
#: typed fabric selector (the old ``Fabric`` string-literal alias)
Fabric = FabricKind
FABRICS = tuple(f.value for f in FabricKind)
Objective = Literal["time", "latency", "transmission"]
OBJECTIVES = ("time", "latency", "transmission")

__all__ = [
    "Candidate", "FABRICS", "Fabric", "FabricKind", "OBJECTIVES",
    "PLAN_KINDS", "PlanKind", "PlanRequest", "PlanResult",
    "RankedAlternative", "SharingMode",
]


@dataclasses.dataclass(frozen=True)
class PlanRequest(RequestBase):
    """One planning problem for the unified `Planner`.

    kind          : 'a2a' | 'rs' | 'ag' | 'ar' (composite AllReduce = RS+AG).
    n, r          : world size and Bruck radix (r=2 is the paper's pattern).
    m_bytes       : total per-node payload in bytes (the paper's m).
    cost_model    : alpha-beta-delta parameters (Section 2).
    fabric        : 'ocs' (reconfigurable, the paper's setting), 'static'
                    (no OCS: only R=0 schedules are feasible; DESIGN.md S3),
                    'ocs-overlap' (sparse reconfiguration with
                    reconfiguration/communication overlap: each boundary is
                    charged `CostModel.delta_sparse(changed, overlap)`
                    instead of a flat delta — see `core.fabricsim`), or
                    'ocs-sim' (event-scored planning: every candidate is
                    completion-timed by the vectorized batch fabric engine,
                    `core.batchsim`, in one call — stragglers, per-port
                    queueing, and pipelining that the analytic score cannot
                    see; requires objective='time').
    overlap       : fraction of delta hidden behind communication, in [0, 1];
                    only meaningful (and only allowed nonzero) for the
                    'ocs-overlap' and 'ocs-sim' fabrics.
    objective     : 'time' (total completion time, Section 3.6), 'latency'
                    (startup + hop latency + reconfig), or 'transmission'
                    (transmission + reconfig) — selects the score used to
                    rank candidates; predicted_time is always the total.
    paper_faithful: restrict to the paper's schedule families (drops the
                    beyond-paper exact-dp strategy).
    strategies    : explicit registry subset (None = all default strategies).
    max_R         : cap on reconfigurations per collective execution; for
                    the composite 'ar' the cap covers RS + AG together (the
                    best split across the phases is searched; the RS->AG
                    transition delta is topology-dependent and not counted).
    delta_budget  : cap on total reconfiguration time R * delta, seconds
                    (combined with max_R; the tighter bound wins).
    ports         : OCS port count; < 2n engages the Section 3.7 blocked-ring
                    distance floor during evaluation (analytic fabrics only;
                    rejected for 'ocs-sim', whose event engine models a
                    full-port OCS).
    init_g        : link offset the fabric was left configured at by a
                    preceding collective (windowed / carryover requests, e.g.
                    the online trace planner).  Candidates are charged the
                    sparse entry-boundary cost of swapping from ``init_g`` to
                    their first link offset, in both score and
                    predicted_time; for the composite 'ar' the entry charge
                    applies to the chosen RS schedule at the composite level.
                    Part of the request's canonical JSON, so the plan cache
                    never serves a plan computed under a different inherited
                    fabric state (requires a reconfigurable fabric).
    tenant        : identity of the tenant this plan is for (multi-tenant
                    fabric sharing, `repro.workloads.tenancy`).  Planning is
                    tenant-independent for identical geometry, but the field
                    is part of the canonical request JSON — and therefore
                    the plan-cache key — so two tenants can never share a
                    cached plan: a later tenant-specific pricing change
                    (per-tenant budgets already differ) must never be served
                    another tenant's stale entry (the same stale-hit bug
                    class `init_g` fixed for carryover state).
    """

    kind: PlanKind
    n: int
    m_bytes: float
    cost_model: CostModel = PAPER_DEFAULT
    r: int = 2
    fabric: FabricKind = FabricKind.OCS
    overlap: float = 0.0
    objective: Objective = "time"
    paper_faithful: bool = False
    strategies: tuple[str, ...] | None = None
    max_R: int | None = None
    delta_budget: float | None = None
    ports: int | None = None
    init_g: int | None = None
    tenant: str | None = None

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"kind must be one of {PLAN_KINDS}, got {self.kind!r}")
        # shared n / r / m_bytes / delta_budget / fabric (coerced, bare
        # strings warn) / overlap / init_g validation (core.jsonio)
        self._validate_base()
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES}, got {self.objective!r}")
        if self.fabric == FabricKind.OCS_SIM and self.objective != "time":
            raise ValueError(
                f"fabric='ocs-sim' event-scores total completion time only; "
                f"objective must be 'time', got {self.objective!r}")
        if self.fabric == FabricKind.OCS_SIM and self.ports is not None:
            raise ValueError(
                "fabric='ocs-sim' simulates a full-port OCS (the batch "
                "engine has no Section 3.7 blocked-ring model); drop ports "
                "or use the analytic 'ocs'/'ocs-overlap' fabrics")
        if self.max_R is not None and self.max_R < 0:
            raise ValueError(f"max_R must be >= 0, got {self.max_R}")
        if self.ports is not None and self.ports < 1:
            raise ValueError(f"ports must be >= 1, got {self.ports}")
        if self.strategies is not None and not isinstance(self.strategies, tuple):
            object.__setattr__(self, "strategies", tuple(self.strategies))

    def effective_max_R(self) -> int | None:
        """Tightest reconfiguration cap implied by max_R and delta_budget."""
        caps = []
        if self.max_R is not None:
            caps.append(self.max_R)
        if self.delta_budget is not None:
            d = self.cost_model.delta
            caps.append(int(self.delta_budget / d) if d > 0 else None)
            caps = [c for c in caps if c is not None]
        return min(caps) if caps else None

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "n": self.n, "m_bytes": self.m_bytes,
            "cost_model": cost_model_to_dict(self.cost_model),
            "r": self.r, "fabric": self.fabric.value, "overlap": self.overlap,
            "objective": self.objective,
            "paper_faithful": self.paper_faithful,
            "strategies": list(self.strategies) if self.strategies is not None else None,
            "max_R": self.max_R, "delta_budget": self.delta_budget,
            "ports": self.ports, "init_g": self.init_g,
            "tenant": self.tenant,
        }

    @staticmethod
    def from_dict(d: dict) -> "PlanRequest":
        require_keys(
            d, required=("kind", "n", "m_bytes", "cost_model"),
            optional=("r", "fabric", "overlap", "objective",
                      "paper_faithful", "strategies", "max_R",
                      "delta_budget", "ports", "init_g", "tenant"),
            what="PlanRequest")
        strategies = d.get("strategies")
        return PlanRequest(
            kind=d["kind"], n=d["n"],
            m_bytes=require_positive_payload(d["m_bytes"], "PlanRequest"),
            cost_model=cost_model_from_dict(d["cost_model"], "PlanRequest"),
            r=d.get("r", 2),
            fabric=FabricKind.coerce(d.get("fabric", "ocs"), warn=False),
            overlap=d.get("overlap", 0.0),
            objective=d.get("objective", "time"),
            paper_faithful=d.get("paper_faithful", False),
            strategies=tuple(strategies) if strategies is not None else None,
            max_R=d.get("max_R"), delta_budget=d.get("delta_budget"),
            ports=d.get("ports"), init_g=d.get("init_g"),
            tenant=d.get("tenant"),
        )


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluable alternative produced by a strategy.

    ``schedule`` is None for non-Bruck implementations (the ring baseline),
    in which case ``impl`` tells the planner how to cost it.
    """

    name: str
    schedule: Schedule | None = None
    impl: str = "bruck"  # 'bruck' | 'ring'


@dataclasses.dataclass(frozen=True)
class RankedAlternative:
    """One row of the PlanResult alternatives table (best score first)."""

    strategy: str               # candidate name, e.g. 'periodic(R=2)'
    impl: str                   # 'bruck' | 'ring'
    predicted_time: float       # total modeled completion time [s]
    score: float                # value of the request's objective
    R: int | None = None        # reconfiguration count (None for non-Bruck)
    x: tuple[int, ...] | None = None  # schedule bits (None for non-Bruck / ar)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["x"] = list(self.x) if self.x is not None else None
        return d

    @staticmethod
    def from_dict(d: dict) -> "RankedAlternative":
        require_keys(d, required=("strategy", "impl", "predicted_time",
                                  "score"),
                     optional=("R", "x"), what="RankedAlternative")
        x = d.get("x")
        return RankedAlternative(
            strategy=d["strategy"], impl=d["impl"],
            predicted_time=d["predicted_time"], score=d["score"],
            R=d.get("R"), x=tuple(x) if x is not None else None)


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """Outcome of one `Planner.plan` call.

    For single collectives (a2a / rs / ag) the winner is ``schedule``; for
    the composite ``ar`` the winner is the (rs_schedule, ag_schedule) pair
    (None when the ring implementation won or the fabric is static-planned
    without explicit schedules).  ``alternatives`` ranks every evaluated
    candidate by the request's objective, best first.
    """

    request: PlanRequest
    strategy: str
    impl: str
    predicted_time: float
    breakdown: TimeBreakdown
    schedule: Schedule | None = None
    rs_schedule: Schedule | None = None
    ag_schedule: Schedule | None = None
    alternatives: tuple[RankedAlternative, ...] = ()

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "request": self.request.to_dict(),
            "strategy": self.strategy,
            "impl": self.impl,
            "predicted_time": self.predicted_time,
            "breakdown": self.breakdown.to_dict(),
            "schedule": _schedule_to_dict(self.schedule),
            "rs_schedule": _schedule_to_dict(self.rs_schedule),
            "ag_schedule": _schedule_to_dict(self.ag_schedule),
            "alternatives": [a.to_dict() for a in self.alternatives],
        }

    @staticmethod
    def from_dict(d: dict) -> "PlanResult":
        require_keys(
            d, required=("request", "strategy", "impl", "predicted_time",
                         "breakdown"),
            optional=("version", "schedule", "rs_schedule", "ag_schedule",
                      "alternatives"),
            what="PlanResult")
        request = PlanRequest.from_dict(d["request"])
        schedules = {
            name: _schedule_from_dict(d.get(name))
            for name in ("schedule", "rs_schedule", "ag_schedule")
        }
        for name, sched in schedules.items():
            if sched is None:
                continue
            if sched.n != request.n or sched.r != request.r:
                raise ValueError(
                    f"PlanResult {name} is for (n={sched.n}, r={sched.r}) "
                    f"but the request is for (n={request.n}, r={request.r})")
        return PlanResult(
            request=request,
            strategy=d["strategy"],
            impl=d["impl"],
            predicted_time=d["predicted_time"],
            breakdown=TimeBreakdown.from_dict(d["breakdown"]),
            schedule=schedules["schedule"],
            rs_schedule=schedules["rs_schedule"],
            ag_schedule=schedules["ag_schedule"],
            alternatives=tuple(RankedAlternative.from_dict(a)
                               for a in d.get("alternatives", [])),
        )

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "PlanResult":
        return PlanResult.from_dict(json.loads(s))


def _schedule_to_dict(s: Schedule | None) -> dict | None:
    if s is None:
        return None
    return {"kind": s.kind, "n": s.n, "x": list(s.x), "r": s.r}


def _schedule_from_dict(d: dict | None) -> Schedule | None:
    if d is None:
        return None
    require_keys(d, required=("kind", "n", "x", "r"), what="Schedule")
    return Schedule(kind=d["kind"], n=d["n"], x=tuple(d["x"]), r=d["r"])

"""Multi-tenant fabric sharing: K concurrent jobs on one optical fabric.

BRIDGE plans one job as if it owned the whole fabric; the serving reality
the ROADMAP targets (and PCCL deploys) is one photonic circuit switch shared
by many distributed-ML jobs at once.  This module plans that sharing under
two disciplines, selected by `repro_torch.core.jsonio.SharingMode`:

  PORT_PARTITION
      Each tenant owns a disjoint contiguous subset of the fabric's ports
      sized to its trace's world (``sum of tenant worlds <= n``) and runs
      its trace on its own sub-fabric, planned by the existing carryover DP
      at the tenant's world size.  Tenants run concurrently and never touch
      each other's circuits, so the isolation ratio is exactly 1.0 and the
      shared makespan is ``max_t C_t <= sum_t C_t`` (the serialized
      baseline) structurally.

  TIME_SLICE
      All tenants need the full fabric (``every tenant world == n``) and
      interleave *whole collectives* on it.  A tenant hand-off is just a
      carryover boundary: `core.schedules.changed_links` prices exactly the
      circuits that differ between the outgoing tenant's final link offsets
      and the incoming tenant's initial ones — a hand-off where the next
      tenant reuses the subring as-is is free.  `plan_shared` evaluates
      candidate interleavings (the request-order serialization, Smith's-rule
      weighted-shortest-block order, and round-robin over collectives) with
      a joint DP (`shared_window_dp`) whose state tracks the fabric's link
      offset plus per-tenant *and* global reconfiguration spend, minimizing
      the exact weighted completion time ``sum_t w_t * C_t``.

Both gates the tenancy bench enforces hold *structurally*, not just
empirically:

  - shared <= serialized: the naive serialization (every tenant planned
    independently, played back-to-back with a full-fabric swap at each
    hand-off) is replayed under shared accounting and kept in the candidate
    pool, and sparse hand-offs never cost more than full swaps; the
    selected plan is the weighted-best among candidates whose makespan does
    not exceed the serialized baseline.
  - per-tenant isolation bound: every tenant's shared completion is at most
    the plan's makespan, which is at most the serialized baseline — so
    ``C_t(shared) / C_t(alone)`` is bounded by
    ``serialized / C_t(alone)``, the bound `TenantPlan.isolation_bound`
    reports and `analysis.verifier` re-checks (``tenant/*`` rules).

`SharedPlan.fabric_phases()` emits the interleaved (schedule, m) tape for
`FabricSim.run_trace` (which plays foreign circuits without resetting port
state — carryover is a first-class input), and `score_shared_plans` pushes
many shared plans through `core.batchsim.batch_run_trace`, grouping lanes
by tape shape so interleavings are scored vectorized where the engine
allows and through the scalar oracle otherwise.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.core.cost_model import CostModel, PAPER_DEFAULT
from repro_torch.core.jsonio import (FabricKind, RequestBase, SharingMode,
                               cost_model_from_dict, cost_model_to_dict,
                               require_keys)
from repro_torch.core.schedules import changed_links

from .trace_planner import (PhaseCandidate, PhasePlan, TRACE_FABRICS,
                            TracePlan, _phase_plan, phase_candidates,
                            plan_trace)
from .traces import Trace

#: relative slack on the structural shared <= serialized comparisons
REL_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's job and its service-level contract.

    trace        : the tenant's collective stream (its ``trace.n`` is the
                   tenant's world size — the whole fabric under TIME_SLICE,
                   its port-partition size under PORT_PARTITION).
    weight       : SLA weight in the shared objective ``sum_t w_t * C_t``
                   (> 0; higher = finishing this tenant earlier matters
                   more).
    delta_budget : cap on this tenant's *intra-collective* reconfiguration
                   stall, seconds (None = inherit a weighted share of the
                   request's global budget, or unbounded).
    port_share   : optional fraction of the fabric's ports this tenant is
                   entitled to under PORT_PARTITION (its world must fit:
                   ``trace.n <= port_share * n``).
    """

    name: str
    trace: Trace
    weight: float = 1.0
    delta_budget: float | None = None
    port_share: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not self.weight > 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}")
        if self.delta_budget is not None and self.delta_budget < 0:
            raise ValueError(
                f"tenant {self.name!r}: delta_budget must be >= 0, got "
                f"{self.delta_budget}")
        if self.port_share is not None and not 0 < self.port_share <= 1:
            raise ValueError(
                f"tenant {self.name!r}: port_share must be in (0, 1], got "
                f"{self.port_share}")

    def to_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace.to_dict(),
                "weight": self.weight, "delta_budget": self.delta_budget,
                "port_share": self.port_share}

    @staticmethod
    def from_dict(d: dict) -> "TenantSpec":
        require_keys(d, required=("name", "trace"),
                     optional=("weight", "delta_budget", "port_share"),
                     what="TenantSpec")
        return TenantSpec(
            name=d["name"], trace=Trace.from_dict(d["trace"]),
            weight=d.get("weight", 1.0),
            delta_budget=d.get("delta_budget"),
            port_share=d.get("port_share"))


@dataclasses.dataclass(frozen=True)
class SharedFabricRequest(RequestBase):
    """K tenants asking to share one fabric of ``n`` ports.

    sharing      : the discipline (`SharingMode`); bare strings coerce with
                   a `DeprecationWarning` like `FabricKind` everywhere else.
    fabric       : 'ocs' or 'ocs-overlap' (the analytic trace fabrics).
    delta_budget : global cap on intra-collective reconfiguration stall
                   across all tenants; tenants without their own budget
                   inherit a weight-proportional share of it.
    """

    tenants: tuple[TenantSpec, ...]
    n: int
    cost_model: CostModel = PAPER_DEFAULT
    fabric: FabricKind = FabricKind.OCS
    sharing: SharingMode = SharingMode.TIME_SLICE
    overlap: float = 0.0
    delta_budget: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "tenants", tuple(self.tenants))
        if not self.tenants:
            raise ValueError("a shared-fabric request needs at least 1 tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            dupes = sorted({x for x in names if names.count(x) > 1})
            raise ValueError(f"tenant names must be unique, got duplicates "
                             f"{dupes}")
        object.__setattr__(self, "sharing", SharingMode.coerce(self.sharing))
        self._validate_base()
        if self.fabric not in TRACE_FABRICS:
            raise ValueError(
                f"fabric must be one of {tuple(map(str, TRACE_FABRICS))}, "
                f"got {str(self.fabric)!r} (shared planning prices tenant "
                f"hand-offs analytically)")
        if self.sharing == SharingMode.TIME_SLICE:
            bad = [t.name for t in self.tenants if t.trace.n != self.n]
            if bad:
                raise ValueError(
                    f"time-sliced tenants interleave on the full fabric: "
                    f"tenant(s) {bad} have trace.n != n={self.n}")
        else:
            total = sum(t.trace.n for t in self.tenants)
            if total > self.n:
                raise ValueError(
                    f"port partition does not fit: tenant worlds sum to "
                    f"{total} > n={self.n} ports")
            for t in self.tenants:
                if (t.port_share is not None
                        and t.trace.n > t.port_share * self.n + 1e-12):
                    raise ValueError(
                        f"tenant {t.name!r} world {t.trace.n} exceeds its "
                        f"port share {t.port_share} of n={self.n} "
                        f"(= {t.port_share * self.n:.1f} ports)")

    def to_dict(self) -> dict:
        return {"tenants": [t.to_dict() for t in self.tenants],
                "n": self.n,
                "cost_model": cost_model_to_dict(self.cost_model),
                "fabric": str(self.fabric), "sharing": str(self.sharing),
                "overlap": self.overlap, "delta_budget": self.delta_budget}

    @classmethod
    def from_dict(cls, d: dict) -> "SharedFabricRequest":
        require_keys(d, required=("tenants", "n"),
                     optional=("cost_model", "fabric", "sharing", "overlap",
                               "delta_budget"),
                     what="SharedFabricRequest")
        return SharedFabricRequest(
            tenants=tuple(TenantSpec.from_dict(t) for t in d["tenants"]),
            n=d["n"],
            cost_model=(cost_model_from_dict(d["cost_model"],
                                             "SharedFabricRequest")
                        if "cost_model" in d else PAPER_DEFAULT),
            fabric=FabricKind.coerce(d.get("fabric", "ocs"), warn=False),
            sharing=SharingMode.coerce(d.get("sharing", "time-slice"),
                                       warn=False),
            overlap=d.get("overlap", 0.0),
            delta_budget=d.get("delta_budget"))

    def resolved_budgets(self) -> dict[str, float | None]:
        """Per-tenant intra-collective stall budgets, seconds.

        A tenant's own ``delta_budget`` wins; tenants without one split the
        request's global budget proportionally to SLA weight (so the global
        cap is never oversubscribed by the derived shares); with neither,
        the tenant is unbounded.
        """
        out: dict[str, float | None] = {}
        if self.delta_budget is None:
            return {t.name: t.delta_budget for t in self.tenants}
        free = [t for t in self.tenants if t.delta_budget is None]
        pool = self.delta_budget - sum(
            t.delta_budget for t in self.tenants if t.delta_budget is not None)
        pool = max(0.0, pool)
        wsum = sum(t.weight for t in free)
        for t in self.tenants:
            if t.delta_budget is not None:
                out[t.name] = t.delta_budget
            else:
                out[t.name] = pool * t.weight / wsum if wsum else 0.0
        return out


@dataclasses.dataclass(frozen=True)
class SharedPhase:
    """One planned phase of a time-sliced interleaving, tagged with its
    owning tenant; ``boundary_*`` price *entering* this phase (0 circuits /
    0 cost for the first phase on a fresh fabric)."""

    tenant: str
    plan: PhasePlan
    boundary_changed: int
    boundary_cost: float

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "plan": self.plan.to_dict(),
                "boundary_changed": self.boundary_changed,
                "boundary_cost": self.boundary_cost}

    @staticmethod
    def from_dict(d: dict) -> "SharedPhase":
        return SharedPhase(tenant=d["tenant"],
                           plan=PhasePlan.from_dict(d["plan"]),
                           boundary_changed=d["boundary_changed"],
                           boundary_cost=d["boundary_cost"])


@dataclasses.dataclass(frozen=True)
class TenantPlan:
    """One tenant's outcome inside a `SharedPlan`.

    ports           : the tenant's ``[lo, hi)`` port range under
                      PORT_PARTITION (None under TIME_SLICE).
    plan            : the tenant's own `TracePlan` under PORT_PARTITION
                      (None under TIME_SLICE, where the shared plan's
                      interleaved ``phases`` carry the schedules).
    completion_s    : when the tenant's last collective completes in the
                      shared execution.
    alone_s         : the tenant planned alone on its fabric under the same
                      budget — the isolation denominator.
    isolation       : measured ``completion_s / alone_s``.
    isolation_bound : structural worst case ``serialized_s / alone_s``
                      (shared completion never exceeds the serialized
                      baseline, so ``isolation <= isolation_bound``).
    """

    name: str
    weight: float
    delta_budget: float | None
    ports: tuple[int, int] | None
    plan: TracePlan | None
    completion_s: float
    alone_s: float
    isolation: float
    isolation_bound: float
    paid_reconfigs: int

    def to_dict(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "delta_budget": self.delta_budget,
                "ports": list(self.ports) if self.ports else None,
                "plan": self.plan.to_dict() if self.plan else None,
                "completion_s": self.completion_s, "alone_s": self.alone_s,
                "isolation": self.isolation,
                "isolation_bound": self.isolation_bound,
                "paid_reconfigs": self.paid_reconfigs}

    @staticmethod
    def from_dict(d: dict) -> "TenantPlan":
        return TenantPlan(
            name=d["name"], weight=d["weight"],
            delta_budget=d["delta_budget"],
            ports=tuple(d["ports"]) if d["ports"] else None,
            plan=TracePlan.from_dict(d["plan"]) if d["plan"] else None,
            completion_s=d["completion_s"], alone_s=d["alone_s"],
            isolation=d["isolation"], isolation_bound=d["isolation_bound"],
            paid_reconfigs=d["paid_reconfigs"])


@dataclasses.dataclass(frozen=True)
class SharedPlan:
    """Outcome of one `plan_shared` call (lossless JSON round trip).

    phases / order        : the chosen interleaving under TIME_SLICE (order
                            names the owning tenant per phase); both empty
                            under PORT_PARTITION, where each `TenantPlan`
                            carries its own `TracePlan`.
    makespan_s            : total shared execution time.
    weighted_completion_s : ``sum_t w_t * C_t``, the DP objective.
    serialized_s / serialized_weighted_s : the naive-serialization baseline
                            (independent plans back-to-back, full-fabric
                            swap per hand-off) on the same metrics — the
                            bench gates ``makespan_s <= serialized_s`` and
                            ``weighted_completion_s <= serialized_weighted_s``
                            row by row.
    """

    request: SharedFabricRequest
    order: tuple[str, ...]
    phases: tuple[SharedPhase, ...]
    tenants: tuple[TenantPlan, ...]
    makespan_s: float
    weighted_completion_s: float
    serialized_s: float
    serialized_weighted_s: float

    @property
    def sharing(self) -> SharingMode:
        return self.request.sharing

    def tenant(self, name: str) -> TenantPlan:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(f"no tenant {name!r} in this shared plan")

    def fabric_phases(self) -> tuple[tuple, ...]:
        """Interleaved (schedule, m) tape for `FabricSim.run_trace` /
        `TraceLane` (TIME_SLICE only: a port partition has no single shared
        tape — each tenant's `TracePlan.fabric_phases()` plays its own
        sub-fabric)."""
        if self.sharing != SharingMode.TIME_SLICE:
            raise ValueError(
                "fabric_phases() is the time-sliced interleaved tape; "
                "port-partitioned tenants each play their own "
                "TracePlan.fabric_phases()")
        return tuple((p.plan.schedule, p.plan.m_bytes) for p in self.phases)

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "request": self.request.to_dict(),
            "order": list(self.order),
            "phases": [p.to_dict() for p in self.phases],
            "tenants": [t.to_dict() for t in self.tenants],
            "makespan_s": self.makespan_s,
            "weighted_completion_s": self.weighted_completion_s,
            "serialized_s": self.serialized_s,
            "serialized_weighted_s": self.serialized_weighted_s,
        }

    @staticmethod
    def from_dict(d: dict) -> "SharedPlan":
        return SharedPlan(
            request=SharedFabricRequest.from_dict(d["request"]),
            order=tuple(d["order"]),
            phases=tuple(SharedPhase.from_dict(p) for p in d["phases"]),
            tenants=tuple(TenantPlan.from_dict(t) for t in d["tenants"]),
            makespan_s=d["makespan_s"],
            weighted_completion_s=d["weighted_completion_s"],
            serialized_s=d["serialized_s"],
            serialized_weighted_s=d["serialized_weighted_s"])

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "SharedPlan":
        return SharedPlan.from_dict(json.loads(s))


# --- the shared joint DP ------------------------------------------------------


def shared_window_dp(n: int, items: Sequence[tuple[int, Sequence[PhaseCandidate]]],
                     cm: CostModel, *, coeffs: Sequence[float],
                     caps: Sequence[int | None], global_cap: int | None = None,
                     overlap: float = 0.0) -> list[PhaseCandidate]:
    """Joint DP over an interleaved multi-tenant phase sequence.

    ``items[p] = (owner, candidates)`` assigns phase position p to tenant
    ``owner``; ``coeffs[p]`` multiplies position p's (boundary + phase)
    cost in the objective — with ``coeffs[p] = sum of weights of tenants
    whose last phase is at position >= p`` the DP minimizes the exact
    weighted completion time ``sum_t w_t * C_t`` (each tenant's completion
    is the prefix sum through its last phase, so every position's cost is
    counted once per still-running tenant).  ``caps[t]`` bounds tenant t's
    paid intra-collective reconfigurations and ``global_cap`` the fleet's
    total, extending `trace_planner.window_dp`'s (offset, spent) state to
    (offset, per-tenant spent vector): reconfigs migrate to the tenants —
    and the collectives — that benefit, but never past a tenant's own cap.
    """
    if not items:
        raise ValueError("shared_window_dp needs at least one phase")
    if len(coeffs) != len(items):
        raise ValueError(f"need one coefficient per phase, got "
                         f"{len(coeffs)} for {len(items)} phases")
    T = len(caps)
    tracked = tuple(t for t in range(T) if caps[t] is not None)

    def spend(vec: tuple, owner: int, paid: int):
        """Update (per-tracked-tenant spent, global spent); None = over cap."""
        tenant_spent, total = vec
        total += paid
        if global_cap is not None and total > global_cap:
            return None
        if owner in tracked and paid:
            i = tracked.index(owner)
            new = tenant_spent[:i] + (tenant_spent[i] + paid,) \
                + tenant_spent[i + 1:]
            if new[i] > caps[owner]:
                return None
            tenant_spent = new
        return (tenant_spent, total)

    zero = ((0,) * len(tracked), 0)
    # state: (g_last, spend vector) -> (objective, prev state, candidate)
    layers: list[dict] = []
    cur: dict = {}
    owner0, cands0 = items[0]
    for cand in cands0:
        vec = spend(zero, owner0, cand.paid)
        if vec is None:
            continue
        obj = coeffs[0] * cand.time
        key = (cand.g_last, vec)
        if key not in cur or obj < cur[key][0]:
            cur[key] = (obj, None, cand)
    for p in range(1, len(items)):
        layers.append(cur)
        owner, cands = items[p]
        nxt: dict = {}
        for (g, vec), (obj, _, _) in cur.items():
            for cand in cands:
                vec2 = spend(vec, owner, cand.paid)
                if vec2 is None:
                    continue
                step = cm.delta_sparse(
                    changed_links(n, g, cand.g_first), overlap) + cand.time
                obj2 = obj + coeffs[p] * step
                key = (cand.g_last, vec2)
                if key not in nxt or obj2 < nxt[key][0]:
                    nxt[key] = (obj2, (g, vec), cand)
        cur = nxt
    if not cur:
        raise ValueError(
            f"per-tenant reconfiguration caps {list(caps)} (global "
            f"{global_cap}) are infeasible for the {len(items)}-phase "
            f"shared window (even R=0 schedules do not fit)")
    best_key = min(cur, key=lambda k: (cur[k][0], k))
    chosen: list[PhaseCandidate] = []
    key = best_key
    for layer in reversed(layers + [cur]):
        _, prev_key, cand = layer[key]
        chosen.append(cand)
        key = prev_key
    chosen.reverse()
    return chosen


# --- interleavings ------------------------------------------------------------


def _event_groups(trace: Trace) -> list[list[tuple[str, float, str]]]:
    """Per-event phase groups, tagged exactly like `Trace.phases()` ('ar'
    keeps its RS + AG phases adjacent)."""
    groups: list[list[tuple[str, float, str]]] = []
    for ev in trace.events:
        if ev.kind == "ar":
            groups.append([("rs", ev.m_bytes, f"{ev.tag}:rs"),
                           ("ag", ev.m_bytes, f"{ev.tag}:ag")])
        else:
            groups.append([(ev.kind, ev.m_bytes, ev.tag)])
    return groups


def candidate_orders(req: SharedFabricRequest,
                     alone_totals: Sequence[float]) -> dict[str, list[int]]:
    """Candidate interleavings, as tenant-index sequences per *collective*.

    Each entry lists which tenant issues the next whole collective (event);
    per-tenant event order is always preserved.  The pool always contains
    the request-order serialization (the shared <= serialized gate needs it
    structurally), Smith's-rule weighted-shortest-block order (optimal block
    serialization for weighted completion), and round-robin.
    """
    K = len(req.tenants)
    counts = [len(t.trace.events) for t in req.tenants]
    orders: dict[str, list[int]] = {}
    orders["serialized"] = [t for t in range(K) for _ in range(counts[t])]
    wspt = sorted(range(K), key=lambda t: (
        -req.tenants[t].weight / alone_totals[t] if alone_totals[t] > 0
        else float("-inf"), t))
    orders["wspt"] = [t for t in wspt for _ in range(counts[t])]
    rr, left = [], list(counts)
    while any(left):
        for t in range(K):
            if left[t]:
                rr.append(t)
                left[t] -= 1
    orders["round-robin"] = rr
    # de-duplicate orders that collapse to the same sequence (e.g. K=1)
    seen: dict[tuple, str] = {}
    out: dict[str, list[int]] = {}
    for name, seq in orders.items():
        key = tuple(seq)
        if key not in seen:
            seen[key] = name
            out[name] = seq
    return out


def _interleave(req: SharedFabricRequest, order: Sequence[int]):
    """Expand a per-collective tenant order into per-phase items:
    (tenant index, (kind, m, tag)) per position."""
    groups = [_event_groups(t.trace) for t in req.tenants]
    cursor = [0] * len(req.tenants)
    items: list[tuple[int, tuple[str, float, str]]] = []
    for t in order:
        for ph in groups[t][cursor[t]]:
            items.append((t, ph))
        cursor[t] += 1
    return items


def _path_metrics(req: SharedFabricRequest, items, chosen):
    """Assemble phases / completions / totals for a chosen candidate path."""
    n, cm, overlap = req.n, req.cost_model, req.overlap
    phases: list[SharedPhase] = []
    g = None
    t_acc = 0.0
    completion = {t.name: 0.0 for t in req.tenants}
    for (owner, (kind, m, tag)), cand in zip(items, chosen, strict=True):
        bc = 0 if g is None else changed_links(n, g, cand.g_first)
        cost = cm.delta_sparse(bc, overlap) if g is not None else 0.0
        t_acc += cost + cand.time
        name = req.tenants[owner].name
        completion[name] = t_acc
        phases.append(SharedPhase(
            tenant=name, plan=_phase_plan(kind, m, tag, cand),
            boundary_changed=bc, boundary_cost=cost))
        g = cand.g_last
    weighted = sum(t.weight * completion[t.name] for t in req.tenants)
    return phases, completion, t_acc, weighted


# --- plan_shared --------------------------------------------------------------


def _plan_port_partition(req: SharedFabricRequest, planner) -> SharedPlan:
    cm, overlap = req.cost_model, req.overlap
    budgets = req.resolved_budgets()
    base = 0
    tenant_plans: list[TenantPlan] = []
    swap = cm.delta_sparse(req.n, overlap)
    completions = []
    for spec in req.tenants:
        tp = plan_trace(spec.trace, cm, mode="carryover", fabric=req.fabric,
                        overlap=overlap, delta_budget=budgets[spec.name],
                        planner=planner, tenant=spec.name)
        completions.append(tp.total_time)
        tenant_plans.append((spec, (base, base + spec.trace.n), tp))
        base += spec.trace.n
    # naive serialization: one tenant at a time on the shared fabric, a
    # full-fabric swap re-establishing circuits at each hand-off
    serialized = sum(completions) + swap * (len(completions) - 1)
    acc, serialized_weighted = 0.0, 0.0
    for (spec, _, _), c in zip(tenant_plans, completions, strict=True):
        acc += (swap if acc > 0 else 0.0) + c
        serialized_weighted += spec.weight * acc
    out = []
    for (spec, ports, tp), c in zip(tenant_plans, completions, strict=True):
        out.append(TenantPlan(
            name=spec.name, weight=spec.weight,
            delta_budget=budgets[spec.name], ports=ports, plan=tp,
            completion_s=c, alone_s=c, isolation=1.0,
            isolation_bound=serialized / c if c > 0 else 1.0,
            paid_reconfigs=tp.paid_reconfigs))
    makespan = max(completions)
    weighted = sum(spec.weight * c
                   for (spec, _, _), c in zip(tenant_plans, completions,
                                              strict=True))
    return SharedPlan(
        request=req, order=(), phases=(), tenants=tuple(out),
        makespan_s=makespan, weighted_completion_s=weighted,
        serialized_s=serialized, serialized_weighted_s=serialized_weighted)


def _plan_time_slice(req: SharedFabricRequest, planner) -> SharedPlan:
    cm, n, overlap = req.cost_model, req.n, req.overlap
    budgets = req.resolved_budgets()
    unit = cm.delta_sparse(n, overlap)

    def cap_of(budget):
        if budget is None or unit <= 0:
            return None
        return int(budget / unit + 1e-12)

    caps = [cap_of(budgets[t.name]) for t in req.tenants]
    global_cap = cap_of(req.delta_budget)

    # tenant-alone plans: the isolation denominators, and the building
    # blocks of the naive serialization baseline
    alone = [plan_trace(t.trace, cm, mode="carryover", fabric=req.fabric,
                        overlap=overlap, delta_budget=budgets[t.name],
                        planner=planner, tenant=t.name)
             for t in req.tenants]
    alone_totals = [tp.total_time for tp in alone]
    swap = unit
    serialized = sum(alone_totals) + swap * (len(alone) - 1)
    acc, serialized_weighted = 0.0, 0.0
    for spec, tot in zip(req.tenants, alone_totals, strict=True):
        acc += (swap if acc > 0 else 0.0) + tot
        serialized_weighted += spec.weight * acc

    # per-tenant per-phase candidate tables (tenant-keyed in the plan cache)
    tables = []
    for spec in req.tenants:
        tables.append({})
        for kind, m, _tag in spec.trace.phases():
            if (kind, m) not in tables[-1]:
                tables[-1][(kind, m)] = phase_candidates(
                    kind, n, spec.trace.r, m, cm, req.fabric, overlap,
                    planner, tenant=spec.name)

    def coeffs_for(items):
        last = {}
        for p, (owner, _) in enumerate(items):
            last[owner] = p
        weights = [t.weight for t in req.tenants]
        out = []
        for p in range(len(items)):
            out.append(sum(w for t, w in enumerate(weights)
                           if last[t] >= p))
        return out

    # candidate paths: per order, the weighted-optimal joint DP path; plus
    # the naive serialization's own choices replayed under shared (sparse
    # hand-off) accounting, which anchors both structural gates
    paths = []
    for name, order in candidate_orders(req, alone_totals).items():
        items = _interleave(req, order)
        cand_lists = [(owner, tables[owner][(kind, m)])
                      for owner, (kind, m, _tag) in items]
        chosen = shared_window_dp(
            n, cand_lists, cm, coeffs=coeffs_for(items), caps=caps,
            global_cap=global_cap, overlap=overlap)
        paths.append((name, items, chosen))
    naive_items = _interleave(
        req, [t for t in range(len(req.tenants))
              for _ in range(len(req.tenants[t].trace.events))])
    naive_chosen = []
    for tp in alone:
        for pp, (kind, m, _tag) in zip(tp.phases, tp.trace.phases(),
                                       strict=True):
            offs = pp.schedule.link_offsets()
            naive_chosen.append(PhaseCandidate(
                strategy=pp.strategy, schedule=pp.schedule, time=pp.time,
                paid=pp.paid_reconfigs, g_first=offs[0], g_last=offs[-1]))
    naive_spent = [tp.paid_reconfigs for tp in alone]
    if global_cap is None or sum(naive_spent) <= global_cap:
        paths.append(("serialized-naive", naive_items, naive_chosen))

    scored = []
    for name, items, chosen in paths:
        phases, completion, makespan, weighted = _path_metrics(
            req, items, chosen)
        scored.append((name, items, phases, completion, makespan, weighted))
    # the selected plan must beat serialization on *both* metrics: filter to
    # makespan <= serialized (the naive replay always qualifies — sparse
    # hand-offs never exceed full swaps), then take the weighted best
    ok = [s for s in scored
          if s[4] <= serialized * (1 + REL_TOL)]
    if not ok:  # numerically impossible; keep the gate honest anyway
        ok = scored
    _, _, phases, completion, makespan, weighted = min(
        ok, key=lambda s: (s[5], s[4]))

    spent = {t.name: 0 for t in req.tenants}
    for p in phases:
        spent[p.tenant] += p.plan.paid_reconfigs
    tenants = []
    for spec, tp in zip(req.tenants, alone, strict=True):
        c, a = completion[spec.name], tp.total_time
        tenants.append(TenantPlan(
            name=spec.name, weight=spec.weight,
            delta_budget=budgets[spec.name], ports=None, plan=None,
            completion_s=c, alone_s=a,
            isolation=c / a if a > 0 else 1.0,
            isolation_bound=serialized / a if a > 0 else 1.0,
            paid_reconfigs=spent[spec.name]))
    return SharedPlan(
        request=req, order=tuple(p.tenant for p in phases),
        phases=tuple(phases), tenants=tuple(tenants),
        makespan_s=makespan, weighted_completion_s=weighted,
        serialized_s=serialized, serialized_weighted_s=serialized_weighted)


def plan_shared(req: SharedFabricRequest, planner=None) -> SharedPlan:
    """Plan K tenants sharing one fabric under ``req.sharing``.

    Guarantees (see the module docstring for why they are structural):
    ``makespan_s <= serialized_s`` and ``weighted_completion_s <=
    serialized_weighted_s``, and every tenant's ``isolation <=
    isolation_bound``.
    """
    if planner is None:
        from repro_torch.planner import default_planner  # deferred: no cycle

        planner = default_planner()
    if req.sharing == SharingMode.PORT_PARTITION:
        return _plan_port_partition(req, planner)
    return _plan_time_slice(req, planner)


# --- batch scoring of interleavings -------------------------------------------


def score_shared_plans(plans: Sequence[SharedPlan], cm: CostModel, *,
                       chunks_per_msg: int = 32) -> list[float]:
    """Event-score many time-sliced shared plans' interleaved tapes.

    Groups the plans' tapes by (n, per-phase sub-step shape) and pushes each
    group through `core.batchsim.batch_run_trace` in one vectorized call
    (same-shape interleavings — e.g. reorderings of equal-length tenant
    blocks — batch together); odd-shaped tapes fall back to their own
    single-lane batch, which `batch_run_trace` may in turn route to the
    scalar `FabricSim.run_trace` oracle.  Returns one completion time per
    plan, in input order.
    """
    from repro_torch.core.batchsim import TraceLane, batch_run_trace, compile_tape

    groups: dict[tuple, list[int]] = {}
    tapes = []
    for i, plan in enumerate(plans):
        phases = plan.fabric_phases()
        shape = (phases[0][0].n,
                 tuple(compile_tape(s).S for s, _ in phases))
        groups.setdefault(shape, []).append(i)
        tapes.append(phases)
    out = [0.0] * len(plans)
    for idx in groups.values():
        lanes = [TraceLane(phases=tapes[i],
                           overlap=plans[i].request.overlap) for i in idx]
        batch = batch_run_trace(lanes, cm, chunks_per_msg=chunks_per_msg)
        for j, i in enumerate(idx):
            out[i] = batch.result(j).completion
    return out

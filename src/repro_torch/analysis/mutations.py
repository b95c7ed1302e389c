"""Mutation-testing harness for the static verifier.

Each `Mutation` corrupts a known-good artifact — a compiled tape, a
`PlanResult` fresh out of the planner, a `TracePlan`, a `ServedPlan`, a
window DP solution, a `FabricSnapshot` — in one specific way and names the
rule id that must catch it.  `run_mutations()` executes them all; the tier-1
test (tests/test_verifier.py) asserts every corruption is caught by its
designated rule, so a verifier rule that silently stops firing fails the
build.

Corruptions bypass the constructors' own validation on purpose
(``dataclasses.replace`` on tapes, field-copied `Schedule` /
`FabricSnapshot` objects): the verifier's job is exactly the artifacts that
*look* well-formed — deserialized from a cache, produced by a buggy DP, or
handed over by another tenant — and the harness must reach the states
post-init checks would reject.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

from repro_torch.core.batchsim import FabricSnapshot, compile_tape
from repro_torch.core.cost_model import PAPER_DEFAULT
from repro_torch.core.schedules import Schedule, every_step_schedule, static_schedule

from .verifier import (verify_degraded, verify_plan, verify_recovery,
                       verify_schedule, verify_served_plan,
                       verify_shared_plan, verify_snapshot, verify_tape,
                       verify_timeline, verify_trace_plan,
                       verify_window_choice)
from .violations import Violation

MB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One named corruption and the rule id that must catch it."""

    name: str
    rule: str
    build: Callable[[], Sequence[Violation]]


@dataclasses.dataclass(frozen=True)
class MutationOutcome:
    name: str
    rule: str
    caught: bool
    fired: tuple[str, ...]


def _tweak(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _field_copy(obj, **overrides):
    """Clone a frozen dataclass without running __post_init__ (reaches the
    states the constructors themselves would reject)."""
    clone = object.__new__(type(obj))
    for f in dataclasses.fields(obj):
        object.__setattr__(clone, f.name,
                           overrides.get(f.name, getattr(obj, f.name)))
    return clone


# --- known-good fixtures (built lazily, shared across mutations) --------------


@functools.lru_cache(maxsize=None)
def _good_schedule() -> Schedule:
    # two segments with distinct gcds (1 and 4): one paid boundary
    return Schedule(kind="a2a", n=16, x=(0, 0, 1, 0), r=2)


def _good_tape():
    return compile_tape(_good_schedule())


@functools.lru_cache(maxsize=None)
def _planner():
    from repro_torch.planner import Planner  # deferred: planner imports analysis

    return Planner(cache_size=32)


@functools.lru_cache(maxsize=None)
def _good_plan():
    from repro_torch.planner import PlanRequest

    return _planner().plan(PlanRequest(kind="a2a", n=16, m_bytes=MB,
                                       init_g=2))


@functools.lru_cache(maxsize=None)
def _good_capped_plan():
    from repro_torch.planner import PlanRequest

    return _planner().plan(PlanRequest(kind="a2a", n=16, m_bytes=MB,
                                       max_R=1))


@functools.lru_cache(maxsize=None)
def _good_trace_plan():
    from repro_torch.workloads.trace_planner import plan_trace
    from repro_torch.workloads.traces import CollectiveEvent, Trace

    trace = Trace(name="mutation-fixture", n=16, events=(
        CollectiveEvent(kind="a2a", m_bytes=MB, tag="t0"),
        CollectiveEvent(kind="ag", m_bytes=MB / 2, tag="t1")))
    return plan_trace(trace, PAPER_DEFAULT, mode="carryover",
                      planner=_planner())


@functools.lru_cache(maxsize=None)
def _good_served_plan():
    from repro_torch.workloads.serve import PlanService, ServeRequest
    from repro_torch.workloads.traces import CollectiveEvent

    service = PlanService(cm=PAPER_DEFAULT, cache_size=0, planner=_planner())
    return service.serve(ServeRequest(events=(
        CollectiveEvent(kind="a2a", m_bytes=MB, tag="t0"),
        CollectiveEvent(kind="ag", m_bytes=MB / 2, tag="t1")),
        n=16, init_g=2))


@functools.lru_cache(maxsize=None)
def _good_window_choice():
    from repro_torch.workloads.trace_planner import phase_candidates, window_dp

    cands = phase_candidates("a2a", 16, 2, MB, PAPER_DEFAULT, "ocs", 0.0,
                             _planner())
    return tuple(window_dp(16, [cands, cands], PAPER_DEFAULT, init_g=1))


@functools.lru_cache(maxsize=None)
def _good_shared_plan():
    """One real time-sliced shared plan (K=2 tenants on one 16-port fabric)."""
    from repro_torch.workloads.tenancy import (SharedFabricRequest, TenantSpec,
                                         plan_shared)
    from repro_torch.workloads.traces import CollectiveEvent, Trace

    ta = Trace(name="mut-a", n=16, events=(
        CollectiveEvent(kind="a2a", m_bytes=MB, tag="t0"),
        CollectiveEvent(kind="ag", m_bytes=MB / 2, tag="t1")))
    tb = Trace(name="mut-b", n=16, events=(
        CollectiveEvent(kind="ag", m_bytes=MB / 4, tag="t0"),))
    return plan_shared(SharedFabricRequest(
        tenants=(TenantSpec("a", ta, weight=2.0), TenantSpec("b", tb)),
        n=16, cost_model=PAPER_DEFAULT), planner=_planner())


@functools.lru_cache(maxsize=None)
def _good_partition_plan():
    """One real port-partitioned shared plan (8 + 4 ports of 16)."""
    from repro_torch.workloads.tenancy import (SharedFabricRequest, TenantSpec,
                                         plan_shared)
    from repro_torch.core.jsonio import SharingMode
    from repro_torch.workloads.traces import CollectiveEvent, Trace

    tc = Trace(name="mut-c", n=8, events=(
        CollectiveEvent(kind="a2a", m_bytes=MB, tag="t0"),))
    td = Trace(name="mut-d", n=4, events=(
        CollectiveEvent(kind="ag", m_bytes=MB / 2, tag="t0"),))
    return plan_shared(SharedFabricRequest(
        tenants=(TenantSpec("c", tc), TenantSpec("d", td)),
        n=16, cost_model=PAPER_DEFAULT,
        sharing=SharingMode.PORT_PARTITION), planner=_planner())


@functools.lru_cache(maxsize=None)
def _good_snapshot() -> FabricSnapshot:
    return FabricSnapshot(n=8, link_offset=2, node_ready=(1.0,) * 8,
                          port_free=(1.5,) * 8)


@functools.lru_cache(maxsize=None)
def _good_recovery():
    """One real fault-recovery cycle (link-down halfway through a small
    mixed trace at n=8) — source of the DegradedState / recovery-plan
    fixtures the fault/* mutations corrupt."""
    from repro_torch.core.fabricsim import FabricSim
    from repro_torch.core.faults import FaultSpec, FaultTimeline
    from repro_torch.workloads.recovery import run_with_recovery
    from repro_torch.workloads.trace_planner import plan_trace
    from repro_torch.workloads.traces import mixed_trace

    trace = mixed_trace(8, moe_layers=1, train_steps=1, decode_steps=2)
    plan = plan_trace(trace, PAPER_DEFAULT, mode="carryover",
                      planner=_planner())
    clean = FabricSim(mode="sparse", chunks_per_msg=8).run_trace(
        plan.fabric_phases(), PAPER_DEFAULT)
    tl = FaultTimeline(n=8, faults=(
        FaultSpec(kind="link-down", time=0.5 * clean.completion, node=3),))
    return run_with_recovery(trace, PAPER_DEFAULT, faults=tl,
                             planner=_planner(), verify=False)


@functools.lru_cache(maxsize=None)
def _good_timeline():
    from repro_torch.core.faults import FaultTimeline

    ds = _good_recovery().degraded
    return FaultTimeline(n=ds.n, faults=(ds.fault,))


# --- the corruption catalogue -------------------------------------------------


def _mut_tape(rule: str, **overrides):
    def build():
        return verify_tape(dataclasses.replace(_good_tape(), **overrides))
    return build


def _mut_plan(fixture, **overrides):
    def build():
        return verify_plan(dataclasses.replace(fixture(), **overrides))
    return build


def _mut_trace(**overrides):
    def build():
        return verify_trace_plan(
            dataclasses.replace(_good_trace_plan(), **overrides),
            cm=PAPER_DEFAULT)
    return build


def _mut_serve(**overrides):
    def build():
        return verify_served_plan(
            dataclasses.replace(_good_served_plan(), **overrides),
            PAPER_DEFAULT)
    return build


def _build_mutations() -> tuple[Mutation, ...]:
    t = _good_tape()

    def bad_x_schedule():
        return verify_schedule(_field_copy(_good_schedule(), x=(1, 0, 1, 0)))

    def plan_kind():
        res = _good_plan()
        wrong = static_schedule("rs", 16)
        return verify_plan(dataclasses.replace(res, schedule=wrong))

    def plan_budget():
        res = _good_capped_plan()
        over = every_step_schedule("a2a", 16)  # R=3 > max_R=1
        return verify_plan(dataclasses.replace(res, schedule=over))

    def plan_rank():
        res = _good_plan()
        return verify_plan(dataclasses.replace(
            res, alternatives=tuple(reversed(res.alternatives))))

    def plan_dedup():
        res = _good_plan()
        dup = next(a for a in res.alternatives if a.x is not None)
        return verify_plan(dataclasses.replace(
            res, alternatives=res.alternatives + (dup,)))

    def trace_phase():
        tp = _good_trace_plan()
        bad0 = dataclasses.replace(tp.phases[0], kind="ag")
        return verify_trace_plan(
            dataclasses.replace(tp, phases=(bad0,) + tp.phases[1:]),
            cm=PAPER_DEFAULT)

    def trace_paid():
        tp = _good_trace_plan()
        bad0 = dataclasses.replace(tp.phases[0],
                                   paid_reconfigs=tp.phases[0].paid_reconfigs + 1)
        return verify_trace_plan(
            dataclasses.replace(tp, phases=(bad0,) + tp.phases[1:]),
            cm=PAPER_DEFAULT)

    def trace_boundary():
        tp = _good_trace_plan()
        flipped = 0 if tp.boundary_changed[0] else tp.trace.n
        return verify_trace_plan(
            dataclasses.replace(
                tp, boundary_changed=_tweak(tp.boundary_changed, 0, flipped)),
            cm=PAPER_DEFAULT)

    def window_g():
        chosen = _good_window_choice()
        bad0 = dataclasses.replace(chosen[0], g_last=chosen[0].g_last + 1)
        return verify_window_choice(16, (bad0,) + chosen[1:])

    def window_paid():
        chosen = _good_window_choice()
        bad0 = dataclasses.replace(chosen[0], paid=chosen[0].paid + 1)
        return verify_window_choice(16, (bad0,) + chosen[1:])

    def window_cap():
        from repro_torch.workloads.trace_planner import PhaseCandidate

        sched = every_step_schedule("a2a", 16)  # honestly pays 3 reconfigs
        cand = PhaseCandidate(strategy="every-step", schedule=sched,
                              time=1e-3, paid=3, g_first=1, g_last=8)
        # a DP claiming this fits under cap=2 has overspent the trace budget
        return verify_window_choice(16, [cand], cap=2)

    def fault_kind():
        tl = _good_timeline()
        meteor = _field_copy(tl.faults[0], kind="meteor-strike")
        return verify_timeline(_field_copy(tl, faults=(meteor,)))

    def fault_order():
        from repro_torch.core.faults import FaultSpec

        tl = _good_timeline()
        f = tl.faults[0]
        earlier = FaultSpec(kind="node-leave", time=f.time / 2, node=1)
        return verify_timeline(_field_copy(tl, faults=(f, earlier)))

    def fault_mask():
        ds = _good_recovery().degraded
        return verify_degraded(_field_copy(ds,
                                           survivors=tuple(range(ds.n))))

    def fault_leak():
        ds = _good_recovery().degraded
        return verify_degraded(_field_copy(ds,
                                           lost_chunks=ds.lost_chunks + 1))

    def fault_conserve():
        rr = _good_recovery()
        ds = _field_copy(rr.degraded,
                         committed_chunks=rr.degraded.committed_chunks + 1)
        return verify_degraded(ds, phases=rr.plan.fabric_phases(),
                               chunks_per_msg=8)

    def fault_route():
        rr = _good_recovery()
        # the original full-trace plan still targets the pre-fault world:
        # serving it post-fault routes traffic over the dead circuit
        return verify_recovery(rr.degraded, rr.plan)

    def fault_replan():
        rr = _good_recovery()
        # right world size, wrong schedules: the restart plan re-runs the
        # whole trace, not the committed remainder
        return verify_recovery(rr.degraded, rr.restart_plan,
                               clean_plan=rr.clean_plan)

    def tenant_ports():
        sp = _good_partition_plan()
        t0 = _field_copy(sp.tenants[0], ports=(2, 10))
        return verify_shared_plan(_field_copy(sp, tenants=(t0,
                                                           sp.tenants[1])))

    def tenant_route():
        sp = _good_partition_plan()
        # hand tenant 'c' (8 ports) tenant 'd''s 4-node plan: its schedules
        # cannot span the partition it owns
        t0 = _field_copy(sp.tenants[0], plan=sp.tenants[1].plan)
        return verify_shared_plan(_field_copy(sp, tenants=(t0,
                                                           sp.tenants[1])))

    def tenant_order():
        sp = _good_shared_plan()
        return verify_shared_plan(_field_copy(sp, phases=sp.phases[:-1],
                                              order=sp.order[:-1]))

    def tenant_budget():
        sp = _good_shared_plan()
        victim = next(t for t in sp.tenants if t.paid_reconfigs > 0)
        bad = tuple(_field_copy(t, paid_reconfigs=t.paid_reconfigs - 1)
                    if t.name == victim.name else t for t in sp.tenants)
        return verify_shared_plan(_field_copy(sp, tenants=bad))

    def tenant_isolation():
        sp = _good_shared_plan()
        return verify_shared_plan(
            _field_copy(sp, serialized_s=sp.makespan_s / 2))

    def snap_shape():
        return verify_snapshot(_field_copy(
            _good_snapshot(), node_ready=_good_snapshot().node_ready[:-1]))

    def snap_range():
        return verify_snapshot(_field_copy(_good_snapshot(), link_offset=0))

    return (
        # --- tape-level: the link-offset algebra -----------------------------
        Mutation("tape offset not j*r^k", "tape/offset-form",
                 _mut_tape("tape/offset-form",
                           offsets=_tweak(t.offsets, 1, 3))),
        Mutation("tape step order scrambled", "tape/structure",
                 _mut_tape("tape/structure",
                           offsets=tuple(reversed(t.offsets)))),
        Mutation("tape digit-class count off by one", "tape/counts",
                 _mut_tape("tape/counts", counts=_tweak(t.counts, 0,
                                                        t.counts[0] + 1))),
        Mutation("tape duplicated offset breaks conservation",
                 "tape/conserve",
                 _mut_tape("tape/conserve", offsets=_tweak(t.offsets, 1, 1))),
        Mutation("tape link offset not the segment gcd", "tape/gcd",
                 _mut_tape("tape/gcd", g_step=(1, 1, 2, 4),
                           hops=(1, 2, 2, 2))),
        Mutation("tape offset unreachable in subring", "tape/reach",
                 _mut_tape("tape/reach", g_step=(1, 1, 3, 3))),
        Mutation("tape hop count wrong", "tape/hops",
                 _mut_tape("tape/hops", hops=_tweak(t.hops, 3, 5))),
        Mutation("tape segment map shifted", "tape/seg",
                 _mut_tape("tape/seg", seg_of=(0, 1, 1, 1))),
        Mutation("tape changed-circuit set zeroed", "tape/changed",
                 _mut_tape("tape/changed",
                           changed_links=(0,) * len(t.changed_links))),
        Mutation("tape subring offset out of range", "tape/subring",
                 _mut_tape("tape/subring", g_step=(16, 16, 16, 16),
                           seg_g=(16, 16))),
        Mutation("schedule reconfigures before step 0", "sch/x-format",
                 bad_x_schedule),
        # --- plan-level: the planner's trust boundary ------------------------
        Mutation("plan winner schedule of the wrong kind", "plan/kind",
                 plan_kind),
        Mutation("plan winner exceeds reconfiguration cap", "plan/budget",
                 plan_budget),
        Mutation("plan predicted time drifts from breakdown", "plan/entry",
                 _mut_plan(_good_plan,
                           predicted_time=_good_plan().predicted_time + 1e-3)),
        Mutation("plan alternatives unsorted", "plan/rank", plan_rank),
        Mutation("plan alternatives duplicated", "plan/dedup", plan_dedup),
        # --- trace-level: offline DP ledgers ---------------------------------
        Mutation("trace phase kind mismatch", "trace/phase", trace_phase),
        Mutation("trace paid-reconfig ledger off by one", "trace/paid",
                 trace_paid),
        Mutation("trace boundary changed-circuit count flipped",
                 "trace/boundary", trace_boundary),
        Mutation("trace total drifts from ledger", "trace/total",
                 _mut_trace(total_time=_good_trace_plan().total_time + 1e-3)),
        # --- serving-level: PlanService / online window ----------------------
        Mutation("served entry boundary mispriced", "serve/entry",
                 _mut_serve(entry_changed=_good_served_plan().entry_changed - 1)),
        Mutation("served final fabric state wrong", "serve/final",
                 _mut_serve(final_g=_good_served_plan().final_g + 1)),
        Mutation("window candidate misreports final offset", "window/g",
                 window_g),
        Mutation("window candidate misreports paid reconfigs", "window/paid",
                 window_paid),
        Mutation("window DP overspends the trace-wide cap", "window/cap",
                 window_cap),
        # --- multi-tenant shared plans ----------------------------------------
        Mutation("shared partition port ranges overlap", "tenant/ports",
                 tenant_ports),
        Mutation("shared partition schedule spans foreign ports",
                 "tenant/route", tenant_route),
        Mutation("shared interleaving drops a tenant phase", "tenant/order",
                 tenant_order),
        Mutation("shared paid-reconfig ledger understated", "tenant/budget",
                 tenant_budget),
        Mutation("shared makespan above serialized baseline",
                 "tenant/isolation", tenant_isolation),
        # --- fabric snapshots -------------------------------------------------
        Mutation("snapshot port arrays truncated", "snap/shape", snap_shape),
        Mutation("snapshot parked on invalid circuit", "snap/range",
                 snap_range),
        # --- faults / degraded mode / recovery --------------------------------
        Mutation("fault timeline with unknown kind", "fault/spec",
                 fault_kind),
        Mutation("fault timeline out of time order", "fault/order",
                 fault_order),
        Mutation("degraded survivors include the dead port", "fault/mask",
                 fault_mask),
        Mutation("degraded chunk ledger leaks in flight", "fault/conserve",
                 fault_leak),
        Mutation("degraded committed count drifts from tapes",
                 "fault/conserve", fault_conserve),
        Mutation("recovery plan routed over the dead circuit", "fault/route",
                 fault_route),
        Mutation("recovery schedules diverge from clean reference",
                 "fault/replan", fault_replan),
    )


def mutations() -> tuple[Mutation, ...]:
    """The full corruption catalogue (fixtures are built lazily on run)."""
    return _build_mutations()


def run_mutations() -> list[MutationOutcome]:
    """Run every mutation; ``caught`` means the designated rule fired."""
    out = []
    for mut in mutations():
        fired = tuple(sorted({v.rule for v in mut.build()}))
        out.append(MutationOutcome(name=mut.name, rule=mut.rule,
                                   caught=mut.rule in fired, fired=fired))
    return out

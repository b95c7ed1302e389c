"""Step-level completion-time simulator on evolving subring topologies.

Evaluates the paper's topology-aware alpha-beta-delta cost model (Section 2)
for a Bruck collective under a BRIDGE reconfiguration schedule by *explicitly*
walking the OCS topology of every step: hop counts come from routing on the
link graph and congestion from per-link flow loads (`validate=True`), or from
the equivalent closed forms h_k = c_k = msg_offset / link_offset (default;
asserted equal in tests).

This is the reproduction-level stand-in for the paper's Astra-Sim + ns-3
setup: the paper's own analysis (Sections 3.3-3.5) is derived in exactly this
cost model, so every theorem is checkable bit-for-bit (see tests/).
"""
from __future__ import annotations

import dataclasses

from .bruck import steps_for
from .cost_model import CostModel
from .schedules import Schedule
from .subrings import BlockedRing, Topology


@dataclasses.dataclass(frozen=True)
class StepCost:
    index: int
    hops: int
    congestion: float
    nbytes: float
    reconfigured: bool
    time: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "StepCost":
        return StepCost(**d)


@dataclasses.dataclass(frozen=True)
class TimeBreakdown:
    """Completion time split into the cost model's four terms."""

    startup: float
    hop_latency: float
    transmission: float
    reconfig: float
    steps: tuple[StepCost, ...] = ()

    @property
    def total(self) -> float:
        return self.startup + self.hop_latency + self.transmission + self.reconfig

    def __add__(self, other: "TimeBreakdown") -> "TimeBreakdown":
        return TimeBreakdown(
            startup=self.startup + other.startup,
            hop_latency=self.hop_latency + other.hop_latency,
            transmission=self.transmission + other.transmission,
            reconfig=self.reconfig + other.reconfig,
            steps=self.steps + other.steps,
        )

    def cumulative(self) -> list[float]:
        out, t = [], 0.0
        for sc in self.steps:
            t += sc.time
            out.append(t)
        return out

    def to_dict(self) -> dict:
        """Lossless plain-data form (floats survive JSON bit-exactly)."""
        return {
            "startup": self.startup,
            "hop_latency": self.hop_latency,
            "transmission": self.transmission,
            "reconfig": self.reconfig,
            "steps": [sc.to_dict() for sc in self.steps],
        }

    @staticmethod
    def from_dict(d: dict) -> "TimeBreakdown":
        return TimeBreakdown(
            startup=d["startup"],
            hop_latency=d["hop_latency"],
            transmission=d["transmission"],
            reconfig=d["reconfig"],
            steps=tuple(StepCost.from_dict(sc) for sc in d.get("steps", [])),
        )


def collective_time(
    schedule: Schedule,
    m: float,
    cm: CostModel,
    *,
    ports: int | None = None,
    validate: bool = False,
    mirrored: bool = False,
) -> TimeBreakdown:
    """Completion time of a Bruck collective under a reconfiguration schedule.

    ports: if set and < 2n, apply the Section 3.7 blocked-ring distance floor.
    validate: recompute hops/congestion by explicit routing on the topology.
    mirrored: paper Section 5 multiport extension — OCS circuits are
      bidirectional and Bruck uses each link in only one direction, so a
      mirrored copy of the collective runs concurrently on the reverse
      direction carrying half the payload: transmission halves, latency
      unchanged (applies equally to RING/HD/S-/G-BRUCK, so relative speedups
      are preserved).
    """
    n, kind = schedule.n, schedule.kind
    steps = steps_for(kind, n, m / 2 if mirrored else m, schedule.r)
    link = schedule.link_offsets(steps)
    blocked = BlockedRing(n=n, ports=ports) if ports is not None and ports < 2 * n else None

    startup = hop_lat = tx = 0.0
    per_step: list[StepCost] = []
    for st, g in zip(steps, link, strict=True):
        if st.offset % g:
            raise ValueError(f"invalid schedule: step {st.index} unreachable (offset "
                             f"{st.offset}, link {g})")
        if blocked is not None:
            h = blocked.effective_hops(st.offset, g)
        else:
            h = st.offset // g
        c = float(h)  # uniform-offset ring traffic: congestion == hops
        if validate and blocked is None:
            topo = Topology(n=n, g=g)
            h_routed = topo.hops(0, st.offset % n)
            c_routed = topo.max_link_load(st.offset)
            assert h_routed == h and c_routed == h, (h, h_routed, c_routed)
        t = cm.step_cost(hops=h, nbytes=st.nbytes, congestion=c)
        startup += cm.alpha_s
        hop_lat += h * cm.alpha_h
        tx += st.nbytes * c * cm.beta
        per_step.append(StepCost(st.index, h, c, st.nbytes, False, t))

    # mark reconfigured steps & charge delta
    recon_steps = [k for k, xk in enumerate(schedule.x) if xk]
    per_step = [
        dataclasses.replace(sc, reconfigured=(sc.index in recon_steps),
                            time=sc.time + (cm.delta if sc.index in recon_steps else 0.0))
        for sc in per_step
    ]
    return TimeBreakdown(
        startup=startup,
        hop_latency=hop_lat,
        transmission=tx,
        reconfig=schedule.R * cm.delta,
        steps=tuple(per_step),
    )


def collective_time_overlap(
    schedule: Schedule,
    m: float,
    cm: CostModel,
    overlap: float,
    *,
    ports: int | None = None,
) -> TimeBreakdown:
    """Analytic completion time with sparse-reconfiguration overlap credit.

    Identical to `collective_time` except for the reconfiguration term: each
    reconfiguration point is charged `CostModel.delta_sparse(changed,
    overlap)` — zero when the boundary reuses the previous segment's link
    offset, and `delta * (1 - overlap)` otherwise — instead of a flat
    delta.  This is the analytic counterpart of `fabricsim.FabricSim`'s
    per-link swap accounting, used by the planner's ``ocs-overlap`` fabric.
    """
    bd = collective_time(schedule, m, cm, ports=ports)
    changed = schedule.reconfig_changed_links()
    recon_steps = [sc.index for sc in bd.steps if sc.reconfigured]
    if len(recon_steps) != len(changed):
        raise RuntimeError(
            f"reconfigured step count {len(recon_steps)} != "
            f"boundary count {len(changed)}")
    sparse_by_step = {k: cm.delta_sparse(c, overlap)
                      for k, c in zip(recon_steps, changed, strict=True)}
    new_steps = tuple(
        dataclasses.replace(sc, time=sc.time - cm.delta + sparse_by_step[sc.index])
        if sc.reconfigured else sc
        for sc in bd.steps)
    return dataclasses.replace(bd, reconfig=sum(sparse_by_step.values()),
                               steps=new_steps)


def allreduce_time(
    rs_schedule: Schedule,
    ag_schedule: Schedule,
    m: float,
    cm: CostModel,
    *,
    ports: int | None = None,
) -> TimeBreakdown:
    """AllReduce via Rabenseifner decomposition: RS phase then AG phase.

    Charges one extra reconfiguration if the AG phase's initial topology
    differs from the RS phase's final topology (the paper's evaluation reports
    RS alone; we account for the transition explicitly, see DESIGN.md S8).
    """
    if rs_schedule.kind != "rs" or ag_schedule.kind != "ag":
        raise ValueError("expected an rs schedule and an ag schedule")
    if rs_schedule.n != ag_schedule.n:
        raise ValueError("mismatched n")
    t_rs = collective_time(rs_schedule, m, cm, ports=ports)
    t_ag = collective_time(ag_schedule, m, cm, ports=ports)
    rs_final = rs_schedule.link_offsets()[-1]
    ag_first = ag_schedule.link_offsets()[0]
    transition = cm.delta if rs_final != ag_first else 0.0
    return t_rs + t_ag + TimeBreakdown(0.0, 0.0, 0.0, transition)


def allreduce_time_overlap(
    rs_schedule: Schedule,
    ag_schedule: Schedule,
    m: float,
    cm: CostModel,
    overlap: float,
    *,
    ports: int | None = None,
) -> TimeBreakdown:
    """`allreduce_time` under the sparse-reconfiguration overlap credit.

    Both phases are scored with `collective_time_overlap`, and the RS->AG
    topology transition (when the AG phase's initial link offset differs
    from the RS phase's final one) is likewise a sparse swap of every
    circuit, charged `delta_sparse(n, overlap)`.
    """
    if rs_schedule.kind != "rs" or ag_schedule.kind != "ag":
        raise ValueError("expected an rs schedule and an ag schedule")
    if rs_schedule.n != ag_schedule.n:
        raise ValueError("mismatched n")
    t_rs = collective_time_overlap(rs_schedule, m, cm, overlap, ports=ports)
    t_ag = collective_time_overlap(ag_schedule, m, cm, overlap, ports=ports)
    rs_final = rs_schedule.link_offsets()[-1]
    ag_first = ag_schedule.link_offsets()[0]
    changed = rs_schedule.n if rs_final != ag_first else 0
    transition = cm.delta_sparse(changed, overlap)
    return t_rs + t_ag + TimeBreakdown(0.0, 0.0, 0.0, transition)

"""Asynchronous per-link discrete-event fabric simulator.

The synchronized event simulator (`eventsim.collective_time_event`) charges
every reconfiguration as a whole-fabric pause of delta and inserts a global
barrier between sub-steps, so it cannot distinguish BRIDGE's *sparse*
reconfiguration — only the circuits that actually change are rewired while
the surviving subring links keep carrying traffic — from a full-fabric one.
`FabricSim` models the fabric at the granularity the claim is made at:

  - every node's optical egress port is an independent resource with its own
    FIFO queue (oldest-sub-step-first among queued chunks) and its own
    configured circuit;
  - a reconfiguration pays delta only on the ports whose circuit actually
    changes, computed by diffing consecutive segment link offsets
    (`Schedule.reconfig_changed_links`); a port swaps as soon as *it* has
    served its last chunk of the old segment, independently of the rest of
    the fabric, and ports with no traffic in a segment skip its circuit
    entirely;
  - a fraction ``overlap`` of delta is hidden behind concurrent
    communication (SWOT-style reconfiguration/communication overlap), so a
    swapping port blocks for ``delta * (1 - overlap)``
    (`CostModel.delta_sparse`);
  - a node begins sub-step k+1 transmissions as soon as its *own* sub-step-k
    receive completed (per-node dependency tracking; no global barrier);
  - scenario knobs: per-link relative speeds (stragglers) and per-destination
    payload scaling (skew).

``mode="full-pause"`` reproduces the legacy synchronized simulator
bit-for-bit (it runs the exact `collective_time_event` loop), which keeps
the Figs 5-12 event-level cross-checks stable; `collective_time_event` is
now a thin wrapper over it.  ``mode="batched"`` routes through the
vectorized tape-playback engine (`core.batchsim`) — sparse semantics, array
ops instead of the per-chunk heap, scalar-oracle fallback when the
canonical-order check trips.

Both scalar modes read their per-schedule precomputation (segment maps, hop
counts, expected per-port service counts, payload structure) from the
memoized `batchsim.compile_tape`, so repeated runs under different scenario
knobs stop paying the rebuild cost.

`run_trace` plays *back-to-back collectives* on one fabric with state
carryover: the phases' segment lists are concatenated, so a collective
boundary behaves exactly like an intra-schedule segment boundary (ports
mid-drain keep draining, each node injects the next collective off its own
final receive, and only the circuits that differ between the previous
phase's final link offsets and the next phase's initial ones are rewired).
Full-pause `run_trace` is bit-for-bit the legacy sum of independent runs —
the cold-fabric baseline of benchmarks/trace_bench.py.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

from .batchsim import (BatchLane, FabricSnapshot, TraceLane, batch_run,
                       batch_run_trace, compile_tape, validate_phases,
                       validate_rates)
from .cost_model import CostModel
from .faults import (ABRUPT_KINDS, DegradedState, FaultTimeline,
                     snapshot_to_tree, world_after)
from .schedules import Schedule, changed_links

_MODES = ("sparse", "full-pause", "batched")


@dataclasses.dataclass(frozen=True)
class FabricResult:
    """Outcome of one `FabricSim.run`.

    completion     : collective completion time (last receive), seconds.
    mode           : 'sparse' (async per-link) or 'full-pause' (legacy).
    step_done      : per sub-step, the time its last receive completed (in
                     full-pause mode each reconfiguration delta is charged at
                     its boundary step, so the entries attribute stall time
                     correctly even though ``completion`` keeps the legacy
                     R*delta-upfront summation order).
    node_done      : per node, the time its final-sub-step receive completed
                     (all equal to ``completion`` in full-pause mode).
    chunks_moved   : total chunk-hop services performed.
    changed_links  : per reconfiguration point, circuits that physically
                     change (diff of consecutive segment link offsets).
    reconfigs_paid : (port, boundary) swaps that paid a blocking delta
                     (R in full-pause mode, where delta is fabric-global).
    delta_stall    : total port-blocking reconfiguration time, seconds
                     (R * delta in full-pause mode).
    """

    completion: float
    mode: str
    step_done: tuple[float, ...]
    node_done: tuple[float, ...]
    chunks_moved: int
    changed_links: tuple[int, ...]
    reconfigs_paid: int
    delta_stall: float


@dataclasses.dataclass(frozen=True)
class TraceFabricResult:
    """Outcome of one `FabricSim.run_trace` over back-to-back collectives.

    completion       : time the last collective's last receive completed.
    phase_done       : per collective, the time its final sub-step's last
                       receive completed (cumulative; the last entry equals
                       ``completion`` in sparse mode, and the full-pause
                       entries are running sums of the independent runs).
    step_done        : per concatenated sub-step across all phases, the time
                       its last receive completed (full-pause entries are the
                       per-phase `FabricResult.step_done` values offset by
                       the completion of the preceding phases).
    node_done        : per node, its final receive time in the last phase.
    boundary_changed : per collective boundary, circuits that differ between
                       the previous phase's final link offsets and the next
                       phase's initial ones (`schedules.changed_links`).
                       In full-pause mode these are reported but never
                       charged: that mode reproduces the legacy
                       sum-of-independent-collectives number bit-for-bit.
    reconfigs_paid   : (port, boundary) swaps that paid a blocking delta,
                       across all phases *and* phase boundaries.
    delta_stall      : total port-blocking reconfiguration time, seconds.
    final_state      : resumable end-of-trace fabric state (populated only
                       when `run_trace` is called with ``capture_state=True``;
                       feed it back as ``initial`` to continue the trace).
                       For a degraded run this is the committed-prefix
                       snapshot (`degraded.snapshot`).
    degraded         : `core.faults.DegradedState` when a fault timeline cut
                       the run short: ``completion`` / ``node_done`` and the
                       un-committed ``phase_done`` / ``step_done`` entries
                       are inf, the accounting covers the committed prefix
                       plus the in-flight chunks, and recovery
                       (`repro_torch.workloads.recovery`) consumes this state.
                       None for a clean run (including one whose faults all
                       land at/after trace completion).
    """

    completion: float
    mode: str
    phase_done: tuple[float, ...]
    step_done: tuple[float, ...]
    node_done: tuple[float, ...]
    chunks_moved: int
    boundary_changed: tuple[int, ...]
    reconfigs_paid: int
    delta_stall: float
    final_state: FabricSnapshot | None = None
    degraded: DegradedState | None = None


@dataclasses.dataclass(frozen=True)
class _EngineOut:
    """Raw sparse-engine outputs shared by `run` and `run_trace`."""

    completion: float
    step_done: tuple[float, ...]
    node_done: tuple[float, ...]
    chunks_moved: int
    reconfigs_paid: int
    delta_stall: float
    port_free: tuple[float, ...]
    cut_chunks: int = 0  # services started before the fault cutoff (if any)


def trace_boundary_changed(schedules: Sequence[Schedule]) -> tuple[int, ...]:
    """Circuits differing at each collective boundary of a schedule sequence.

    Entry i compares the final per-sub-step link offset of ``schedules[i]``
    with the initial one of ``schedules[i + 1]``: the carryover boundary pays
    delta only on these circuits (0 when collective i ends on exactly the
    offsets collective i + 1 starts with).
    """
    return tuple(
        changed_links(prev.n, prev.link_offsets()[-1], nxt.link_offsets()[0])
        for prev, nxt in zip(schedules, schedules[1:], strict=False))


# canonical implementations live in batchsim (imported by both engines)
_validate_rates = validate_rates
_validate_phases = validate_phases


class FabricSim:
    """Asynchronous per-link discrete-event fabric (see module docstring).

    chunks_per_msg : MTU-like pipelining knob (chunks per per-step message).
    overlap        : fraction of delta hidden behind communication, in [0, 1]
                     (sparse/batched modes; full-pause always blocks the
                     fabric).
    mode           : 'sparse' (per-chunk event loop) | 'full-pause' (legacy
                     synchronized loop) | 'batched' (vectorized tape playback
                     with sparse semantics, see `core.batchsim`).
    link_speed     : per-node relative egress rate (1.0 nominal, < 1 models a
                     degraded transceiver / straggler).
    payload_scale  : per-destination payload multiplier — the message a node
                     sends in a sub-step is scaled by the factor of its
                     (immediate) destination, modeling skewed payloads.
    """

    def __init__(self, *, chunks_per_msg: int = 32, overlap: float = 0.0,
                 mode: str = "sparse",
                 link_speed: list[float] | None = None,
                 payload_scale: list[float] | None = None):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if not 0.0 <= overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {overlap}")
        if mode == "full-pause" and payload_scale is not None:
            raise ValueError(
                "payload_scale requires mode='sparse' or 'batched' "
                "(full-pause is the legacy uniform-payload compatibility mode)")
        if mode == "full-pause" and overlap != 0.0:
            raise ValueError(
                "overlap requires mode='sparse' or 'batched': full-pause "
                "always blocks the whole fabric for the full delta")
        self.chunks_per_msg = max(1, int(chunks_per_msg))
        self.overlap = float(overlap)
        self.mode = mode
        self.link_speed = link_speed
        self.payload_scale = payload_scale

    # --- public API ----------------------------------------------------------

    def run(self, schedule: Schedule, m: float, cm: CostModel) -> FabricResult:
        if self.mode == "full-pause":
            return self._run_full_pause(schedule, m, cm)
        if self.mode == "batched":
            return self._run_batched(schedule, m, cm)
        return self._run_sparse(schedule, m, cm)

    def run_trace(self, phases: Sequence[tuple[Schedule, float]],
                  cm: CostModel, *, initial: FabricSnapshot | None = None,
                  capture_state: bool = False,
                  faults: FaultTimeline | None = None,
                  checkpoint_dir: str | None = None,
                  checkpoint_every: int = 1) -> TraceFabricResult:
        """Play back-to-back collectives on one fabric without resetting ports.

        ``phases`` is a sequence of (schedule, m_bytes) pairs sharing one
        world size n.  In sparse/batched mode the phases are concatenated
        into one playback: a port mid-drain at a collective boundary keeps
        draining exactly like at an intra-schedule segment boundary, each
        node injects phase p+1 as soon as its *own* phase-p final receive
        completed, and the boundary pays delta only on the circuits that
        actually change between the previous phase's final link offsets and
        the next phase's initial ones.  ``mode='full-pause'`` reproduces the
        legacy sum-of-independent-collectives number bit-for-bit (each phase
        restarts from a pre-established topology and no boundary is charged),
        which is the cold-fabric execution baseline of benchmarks/trace_bench.

        ``initial`` resumes mid-trace from a `FabricSnapshot` (ports start at
        the snapshot's busy-until times and configured circuit; entering the
        first phase is a carryover boundary like any other) and
        ``capture_state=True`` records the resumable end state in
        ``final_state`` — together they let a trace be split at any
        collective boundary and replayed in pieces, which is what the online
        planner's re-plan-from-committed-prefix relies on.  Both require
        sparse/batched mode (full-pause is the stateless legacy baseline).

        ``faults`` injects a `core.faults.FaultTimeline`: the earliest fault
        that takes effect before the clean run drains cuts the run short and
        the result carries a `DegradedState` (see `core.faults` for the
        phase-granularity semantics; faults at/after completion are no-ops
        and return the clean result).  ``checkpoint_dir`` writes an atomic
        `FabricSnapshot` checkpoint via `repro_torch.checkpoint.store` every
        ``checkpoint_every`` collective boundaries, so recovery can resume
        from the last committed boundary instead of t=0; the returned result
        is equal to the uninterrupted run (the boundary-snapshot invariant).
        The two are mutually exclusive in one call — checkpoint the clean
        run, then replay the faulted one from the restored snapshot
        (`repro_torch.workloads.recovery` drives that loop).
        """
        phases = _validate_phases(phases)
        if self.mode == "full-pause":
            if (initial is not None or capture_state or faults is not None
                    or checkpoint_dir is not None):
                raise ValueError(
                    "snapshot/restore, fault injection and checkpointing "
                    "require mode='sparse' or 'batched': full-pause is the "
                    "stateless legacy baseline (every collective restarts "
                    "from a pre-established topology)")
            return self._trace_full_pause(phases, cm)
        n = phases[0][0].n
        if initial is not None and initial.n != n:
            raise ValueError(
                f"initial snapshot is for n={initial.n}, phases have "
                f"n={n}")
        if faults is not None:
            if checkpoint_dir is not None:
                raise ValueError(
                    "faults and checkpoint_dir are mutually exclusive in "
                    "one call: checkpoint the clean run, then replay the "
                    "faulted one from the restored snapshot "
                    "(repro_torch.workloads.recovery drives that loop)")
            if faults.n != n:
                raise ValueError(
                    f"fault timeline is for n={faults.n}, phases have n={n}")
        if checkpoint_dir is not None:
            return self._trace_checkpointed(
                phases, cm, checkpoint_dir, max(1, int(checkpoint_every)),
                initial=initial, capture_state=capture_state)
        if self.mode == "batched":
            lane = TraceLane(
                phases=phases, overlap=self.overlap,
                link_speed=(tuple(self.link_speed)
                            if self.link_speed is not None else None),
                payload_scale=(tuple(self.payload_scale)
                               if self.payload_scale is not None else None),
                initial=initial, faults=faults)
            batch = batch_run_trace(
                [lane], cm, chunks_per_msg=self.chunks_per_msg)
            res = batch.result(0)
            if capture_state:
                final = (res.degraded.snapshot if res.degraded is not None
                         else batch.snapshot(0))
                res = dataclasses.replace(res, final_state=final)
            return res
        if faults is not None:
            return self._trace_faulted(phases, cm, faults, initial=initial,
                                       capture_state=capture_state)
        out = self._sparse_engine(phases, cm, initial=initial)
        last, k = [], 0
        for sched, _ in phases:
            k += compile_tape(sched).S
            last.append(k - 1)
        final_state = None
        if capture_state:
            final_state = FabricSnapshot(
                n=phases[0][0].n,
                link_offset=phases[-1][0].link_offsets()[-1],
                node_ready=out.node_done, port_free=out.port_free,
                chunks_moved=out.chunks_moved,
                reconfigs_paid=out.reconfigs_paid,
                delta_stall=out.delta_stall)
        return TraceFabricResult(
            completion=out.completion, mode=self.mode,
            phase_done=tuple(out.step_done[i] for i in last),
            step_done=out.step_done,
            node_done=out.node_done, chunks_moved=out.chunks_moved,
            boundary_changed=trace_boundary_changed([s for s, _ in phases]),
            reconfigs_paid=out.reconfigs_paid, delta_stall=out.delta_stall,
            final_state=final_state)

    def _trace_full_pause(self, phases, cm: CostModel) -> TraceFabricResult:
        """Sum of independent full-pause runs, bit-for-bit (the baseline)."""
        total, phase_done = 0.0, []
        step_done: list[float] = []
        chunks = reconfigs = 0
        stall = 0.0
        for sched, m in phases:
            res = self._run_full_pause(sched, m, cm)
            step_done.extend(total + t for t in res.step_done)
            total += res.completion  # same float order as sum(independents)
            phase_done.append(total)
            chunks += res.chunks_moved
            reconfigs += res.reconfigs_paid
            stall += res.delta_stall
        n = phases[0][0].n
        return TraceFabricResult(
            completion=total, mode=self.mode, phase_done=tuple(phase_done),
            step_done=tuple(step_done),
            node_done=(total,) * n, chunks_moved=chunks,
            boundary_changed=trace_boundary_changed([s for s, _ in phases]),
            reconfigs_paid=reconfigs, delta_stall=stall)

    # --- fault injection and checkpointed playback ---------------------------

    def _trace_faulted(self, phases, cm: CostModel, faults: FaultTimeline,
                       *, initial, capture_state) -> TraceFabricResult:
        """Scalar faulted playback: play the trace, find the earliest fault
        that takes effect, and surface the committed prefix as a
        `DegradedState` (phase-granularity semantics, see `core.faults`).

        The clean prefix timings are reused verbatim from the clean run —
        the sparse engine's per-port segment gate means prefix timings never
        depend on suffix traffic, so the committed phases of a faulted run
        are bit-identical to the same phases of the clean one."""
        n = phases[0][0].n
        P = len(phases)
        clean = self.run_trace(phases, cm, initial=initial,
                               capture_state=capture_state)
        pick = None
        for f in faults.faults:
            if f.kind in ABRUPT_KINDS:
                if f.time < clean.completion:
                    done = sum(1 for t in clean.phase_done if t <= f.time)
                    pick = (f, done, done)  # aborts the in-flight phase
                    break
            else:
                # graceful: the in-flight phase drains; effect lands on the
                # first collective boundary at/after the fault time
                done = sum(1 for t in clean.phase_done if t < f.time) + 1
                if done < P:
                    pick = (f, done, None)
                    break
        if pick is None:
            return clean  # no fault takes effect before the trace drains
        fault, completed, aborted = pick

        if fault.kind == "link-down":
            resume = fault.time
        elif fault.kind == "link-flap":
            resume = fault.time + fault.repair_s
        else:
            resume = clean.phase_done[completed - 1]

        if completed > 0:
            snap = self.run_trace(phases[:completed], cm, initial=initial,
                                  capture_state=True).final_state
        else:
            snap = initial
        base = initial.chunks_moved if initial is not None else 0
        committed = (snap.chunks_moved - base) if snap is not None else 0

        in_flight = 0
        if aborted is not None:
            # abrupt: count every chunk service started strictly before the
            # fault; the ones beyond the committed prefix were in flight
            out = self._sparse_engine(phases, cm, initial=initial,
                                      cutoff=fault.time)
            in_flight = max(0, out.cut_chunks - committed)
        survivors, dead = world_after(n, fault)
        degraded = DegradedState(
            fault=fault, policy=faults.policy, n=n, survivors=survivors,
            dead_ports=dead, completed_phases=completed,
            aborted_phase=aborted, resume_clock=resume, snapshot=snap,
            committed_chunks=committed, in_flight_chunks=in_flight,
            lost_chunks=in_flight if faults.policy == "drop" else 0,
            requeued_chunks=in_flight if faults.policy == "requeue" else 0)

        inf = float("inf")
        kept = 0  # concatenated sub-steps belonging to committed phases
        for sched, _ in phases[:completed]:
            kept += compile_tape(sched).S
        return TraceFabricResult(
            completion=inf, mode=self.mode,
            phase_done=(clean.phase_done[:completed]
                        + (inf,) * (P - completed)),
            step_done=(clean.step_done[:kept]
                       + (inf,) * (len(clean.step_done) - kept)),
            node_done=(inf,) * n,
            chunks_moved=base + committed + in_flight,
            boundary_changed=clean.boundary_changed,
            reconfigs_paid=snap.reconfigs_paid if snap is not None else 0,
            delta_stall=snap.delta_stall if snap is not None else 0.0,
            final_state=snap if capture_state else None,
            degraded=degraded)

    def _trace_checkpointed(self, phases, cm: CostModel, directory: str,
                            every: int, *, initial,
                            capture_state) -> TraceFabricResult:
        """Chunked playback with an atomic `FabricSnapshot` checkpoint
        (`repro_torch.checkpoint.store`) every ``every`` collective boundaries.
        Equal to the uninterrupted run: each chunk resumes from the previous
        chunk's captured snapshot, which the boundary-snapshot invariant
        makes exact, and the timings are absolute so concatenation is the
        full-run sequence."""
        from repro_torch.checkpoint import store  # deferred: store imports jax

        phase_done: list[float] = []
        step_done: list[float] = []
        snap, res, done = initial, None, 0
        while done < len(phases):
            chunk = phases[done:done + every]
            res = self.run_trace(chunk, cm, initial=snap, capture_state=True)
            snap = res.final_state
            phase_done.extend(res.phase_done)
            step_done.extend(res.step_done)
            done += len(chunk)
            store.save(directory, done, snapshot_to_tree(snap))
        return TraceFabricResult(
            completion=res.completion, mode=self.mode,
            phase_done=tuple(phase_done), step_done=tuple(step_done),
            node_done=res.node_done, chunks_moved=res.chunks_moved,
            boundary_changed=trace_boundary_changed([s for s, _ in phases]),
            reconfigs_paid=res.reconfigs_paid, delta_stall=res.delta_stall,
            final_state=snap if capture_state else None)

    # --- batched (vectorized tape playback) mode ----------------------------

    def _run_batched(self, schedule: Schedule, m: float,
                     cm: CostModel) -> FabricResult:
        """Single-lane `batchsim.batch_run` (sparse semantics, array ops)."""
        n = schedule.n
        if self.link_speed is not None:
            _validate_rates("link_speed", self.link_speed, n)
        if self.payload_scale is not None:
            _validate_rates("payload_scale", self.payload_scale, n)
        lane = BatchLane(
            schedule=schedule, m_bytes=m, overlap=self.overlap,
            link_speed=(tuple(self.link_speed)
                        if self.link_speed is not None else None),
            payload_scale=(tuple(self.payload_scale)
                           if self.payload_scale is not None else None))
        return batch_run([lane], cm, chunks_per_msg=self.chunks_per_msg).result(0)

    # --- full-pause (legacy-compatible) mode ---------------------------------

    def _run_full_pause(self, schedule: Schedule, m: float,
                        cm: CostModel) -> FabricResult:
        """Synchronized steps + whole-fabric delta pauses, bit-identical to the
        pre-FabricSim `collective_time_event` accumulation order."""
        from .eventsim import simulate_step  # deferred: eventsim wraps us back

        n = schedule.n
        if self.link_speed is not None:
            _validate_rates("link_speed", self.link_speed, n)
        tape = compile_tape(schedule)
        # ``total`` keeps the legacy accumulation order (R*delta upfront) so
        # ``completion`` stays bit-identical to the pre-FabricSim simulator;
        # ``done`` charges each delta at its actual boundary so ``step_done``
        # attributes reconfiguration time to the step that pays it (it can
        # differ from ``total`` in the last ulp due to summation order).
        total = schedule.R * cm.delta
        done = 0.0
        step_done: list[float] = []
        chunks_moved = 0
        for off, cnt, g, xk in zip(tape.offsets, tape.counts, tape.g_step,
                                   tape.boundary, strict=True):
            if xk:
                done += cm.delta
            total += cm.alpha_s
            done += cm.alpha_s
            res = simulate_step(n, g, off, m * cnt / n, cm,
                                self.chunks_per_msg, self.link_speed)
            total += res.completion
            done += res.completion
            chunks_moved += res.chunks_moved
            step_done.append(done)
        return FabricResult(
            completion=total, mode=self.mode, step_done=tuple(step_done),
            node_done=(total,) * n, chunks_moved=chunks_moved,
            changed_links=tape.changed_links,
            reconfigs_paid=schedule.R, delta_stall=schedule.R * cm.delta)

    # --- sparse asynchronous mode --------------------------------------------

    def _run_sparse(self, schedule: Schedule, m: float,
                    cm: CostModel) -> FabricResult:
        out = self._sparse_engine(((schedule, m),), cm)
        return FabricResult(
            completion=out.completion, mode=self.mode,
            step_done=out.step_done, node_done=out.node_done,
            chunks_moved=out.chunks_moved,
            changed_links=compile_tape(schedule).changed_links,
            reconfigs_paid=out.reconfigs_paid, delta_stall=out.delta_stall)

    def _sparse_engine(self, phases: Sequence[tuple[Schedule, float]],
                       cm: CostModel,
                       initial: FabricSnapshot | None = None,
                       cutoff: float | None = None) -> _EngineOut:
        """Asynchronous per-link event loop over one or more concatenated
        phases.  A single phase is exactly the pre-trace `run` semantics; for
        a trace the phases' segment lists are concatenated, so a collective
        boundary behaves like any other segment boundary (ports drain, then
        swap only if the next used segment needs a different circuit).  With
        ``initial`` the ports resume from the snapshot's busy-until times and
        configured circuit, injections chain off the snapshot's per-node
        ready times, and the accounting counters continue cumulatively.
        ``cutoff`` counts (without altering the timeline) the chunk services
        whose start time precedes it — the fault injector's in-flight census
        (strictly-before: a service starting exactly at the cutoff never
        left its source port)."""
        n = phases[0][0].n
        tapes = [compile_tape(sched) for sched, _ in phases]
        offsets: list[int] = []
        hops: list[int] = []
        nbytes_step: list[float] = []
        seg_of: list[int] = []
        seg_g: list[int] = []
        seg_hops: list[int] = []
        for (_, m), tape in zip(phases, tapes, strict=True):
            base = len(seg_g)
            offsets.extend(tape.offsets)
            hops.extend(tape.hops)
            nbytes_step.extend(m * cnt / n for cnt in tape.counts)
            seg_of.extend(base + si for si in tape.seg_of)
            seg_g.extend(tape.seg_g)
            seg_hops.extend(tape.seg_hops)
        S = len(offsets)
        nseg = len(seg_g)
        speed = ([1.0] * n if self.link_speed is None
                 else _validate_rates("link_speed", self.link_speed, n))
        scale = (None if self.payload_scale is None
                 else _validate_rates("payload_scale", self.payload_scale, n))
        C = self.chunks_per_msg
        delta_eff = cm.delta_sparse(1, self.overlap)
        alpha_s, alpha_h, beta = cm.alpha_s, cm.alpha_h, cm.beta

        def chunk_bytes(u: int, k: int) -> float:
            nbytes = nbytes_step[k]
            if scale is not None:
                nbytes *= scale[(u + offsets[k]) % n]
            return nbytes / C

        # expected chunk services per (port, segment): the swap trigger.
        # Uniform-offset ring traffic visits every port identically, so the
        # per-segment count is just C * (total hops in the segment).
        expected = [[C * sh for sh in seg_hops] for _ in range(n)]

        # per-port state (warm-started from the snapshot when resuming)
        cfg_seg = [0] * n            # segment whose traffic the port serves
        cfg_g = [seg_g[0]] * n       # circuit offset physically configured
        free = [0.0] * n             # port busy-until (service or swap)
        served = [[0] * nseg for _ in range(n)]
        pend: list[list] = [[] for _ in range(n)]  # (seg, step, t, seq, u, c, j)

        rcount = [[0] * S for _ in range(n)]
        recv_done = [[0.0] * S for _ in range(n)]
        step_done = [0.0] * S
        chunks_moved = 0
        cut_chunks = 0
        reconfigs_paid = 0
        delta_stall = 0.0
        if initial is not None:
            free = list(initial.port_free)
            chunks_moved = initial.chunks_moved
            reconfigs_paid = initial.reconfigs_paid
            delta_stall = initial.delta_stall
            if seg_g[0] != initial.link_offset:
                # entering the resumed phases is a carryover boundary like
                # any other: every port carries first-segment traffic, so
                # every port swaps off the inherited circuit
                for port in range(n):
                    free[port] += delta_eff
                    delta_stall += delta_eff
                    reconfigs_paid += 1

        heap: list[tuple] = []  # (t, seq, is_free, port, step, src, chunk, hop)
        seq = 0
        if initial is not None:
            # inherited busy-until times have no in-run completion event, so
            # seed one free event per port: a chunk arriving while the port
            # is still draining snapshot-time work (or the entry swap) must
            # be re-triggered, not stranded in pend
            for port in range(n):
                heapq.heappush(heap, (free[port], seq, 1, port, 0, 0, 0, 0))
                seq += 1

        def advance(port: int) -> None:
            """Move the port past fully-served segments, paying delta only
            when the next *used* segment needs a different circuit."""
            nonlocal reconfigs_paid, delta_stall, seq
            moved = False
            while (cfg_seg[port] < nseg - 1
                   and served[port][cfg_seg[port]] >= expected[port][cfg_seg[port]]):
                nxt = cfg_seg[port] + 1
                if expected[port][nxt] > 0 and seg_g[nxt] != cfg_g[port]:
                    free[port] += delta_eff  # swap starts after the last service
                    delta_stall += delta_eff
                    reconfigs_paid += 1
                    cfg_g[port] = seg_g[nxt]
                cfg_seg[port] = nxt
                moved = True
            if moved:
                heapq.heappush(heap, (free[port], seq, 1, port, 0, 0, 0, 0))
                seq += 1

        def serve(port: int, now: float) -> None:
            nonlocal chunks_moved, cut_chunks, seq
            if not pend[port] or pend[port][0][0] != cfg_seg[port]:
                return
            if free[port] > now:
                return  # busy: the pending free event re-triggers us
            si, k, t_arr, _, u, c, j = heapq.heappop(pend[port])
            start = free[port] if free[port] > t_arr else t_arr
            if cutoff is not None and start < cutoff:
                cut_chunks += 1
            tx = chunk_bytes(u, k) * beta / speed[port]
            free[port] = start + tx
            served[port][si] += 1
            chunks_moved += 1
            t_next = start + tx + alpha_h
            heapq.heappush(heap, (free[port], seq, 1, port, 0, 0, 0, 0))
            seq += 1
            g = seg_g[si]
            if j + 1 < hops[k]:
                nxt_port = (u + (j + 1) * g) % n
                heapq.heappush(heap, (t_next, seq, 0, nxt_port, k, u, c, j + 1))
                seq += 1
            else:
                deliver((u + offsets[k]) % n, k, t_next)
            if served[port][si] == expected[port][si]:
                advance(port)

        def deliver(v: int, k: int, t_arr: float) -> None:
            nonlocal seq
            rcount[v][k] += 1
            if t_arr > recv_done[v][k]:
                recv_done[v][k] = t_arr
            if t_arr > step_done[k]:
                step_done[k] = t_arr
            if rcount[v][k] == C and k + 1 < S:
                t_inj = recv_done[v][k] + alpha_s
                for c in range(C):
                    heapq.heappush(heap, (t_inj, seq, 0, v, k + 1, v, c, 0))
                    seq += 1

        for u in range(n):
            t0 = (alpha_s if initial is None
                  else initial.node_ready[u] + alpha_s)
            for c in range(C):
                heapq.heappush(heap, (t0, seq, 0, u, 0, u, c, 0))
                seq += 1
        for port in range(n):
            advance(port)  # fast-forward ports with no early-segment traffic

        while heap:
            t, sq, is_free, port, k, u, c, j = heapq.heappop(heap)
            if not is_free:
                heapq.heappush(pend[port], (seg_of[k], k, t, sq, u, c, j))
            serve(port, t)

        node_done = tuple(recv_done[v][S - 1] for v in range(n))
        return _EngineOut(
            completion=max(node_done), step_done=tuple(step_done),
            node_done=node_done, chunks_moved=chunks_moved,
            reconfigs_paid=reconfigs_paid, delta_stall=delta_stall,
            port_free=tuple(free), cut_chunks=cut_chunks)


def simulate_fabric(schedule: Schedule, m: float, cm: CostModel,
                    **knobs) -> FabricResult:
    """Convenience wrapper: ``FabricSim(**knobs).run(schedule, m, cm)``."""
    return FabricSim(**knobs).run(schedule, m, cm)


def simulate_trace(phases: Sequence[tuple[Schedule, float]], cm: CostModel,
                   **knobs) -> TraceFabricResult:
    """Convenience wrapper: ``FabricSim(**knobs).run_trace(phases, cm)``."""
    return FabricSim(**knobs).run_trace(phases, cm)


def straggler_speeds(n: int, slow: dict[int, float]) -> list[float]:
    """Per-link rate vector with nodes in ``slow`` running at the given rate
    (e.g. ``{n // 2: 0.25}`` = one transceiver at quarter speed)."""
    speeds = [1.0] * n
    for node, rate in slow.items():
        if not 0 <= node < n:
            raise ValueError(f"straggler node {node} outside [0, {n})")
        if rate <= 0:
            raise ValueError(f"straggler rate must be > 0, got {rate}")
        speeds[node] = rate
    return speeds

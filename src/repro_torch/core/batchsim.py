"""NumPy-vectorized batch fabric engine: compiled schedule tapes + playback.

`FabricSim`'s sparse mode is a per-chunk Python ``heapq`` loop: every run
re-derives the segment maps, hop counts, and expected service counts from the
`Schedule`, then pushes O(n * chunks * sum(hops)) events through a heap.
That is fine for one scenario, but too slow to sit on the planning hot path
where a candidate set of 30+ schedules must be event-scored per request, or
to reach n >= 768 fabrics at all.

This module splits the work the way a compiler does:

  - `compile_tape(schedule)` lowers a `Schedule` once into a reusable
    `ScheduleTape`: per-sub-step link offsets, hop counts, integer payload
    counts (so any m is one multiply away), segment maps, and the
    changed-circuit mask at every reconfiguration boundary.  Tapes are
    memoized per schedule (`functools.lru_cache`), so even the scalar sparse
    loop stops paying the rebuild cost when only scenario knobs change.
  - `batch_run(lanes, cm)` plays B *lanes* — (schedule, m_bytes, delta,
    overlap, straggler / skew vector) configurations — forward together,
    step by step, with array ops over the ``[B, n, chunks]`` grid.

Exactness.  The playback serves each port's traffic in the *canonical*
order: segments strictly in sequence (the scalar simulator enforces this via
its per-port segment gate), steps in order within a segment, and hop streams
in order within a step, with every chunk's service start computed as
``max(arrival, port_free)`` in the same float-op order as the scalar loop.
The event-driven heap follows exactly this order unless traffic *overtakes*:
a later step's chunk reaching a port before an earlier step's chunk has
arrived (the port could go idle and serve out of order), or a hop-1 chunk
arriving before the port's own injection.  Both conditions are checked from
the computed timeline — they are sufficient conditions for the heap execution
to coincide with the canonical one — and any lane that trips a check is
transparently re-run through the scalar `FabricSim` oracle
(``BatchFabricResult.fast_path`` records which lanes took which path).  The
differential-fuzz suite (tests/test_batchsim.py) pins fast-path results to
the scalar loop at 1e-9 relative tolerance across a seeded
n x r x R x delta x straggler grid.

Most lanes never needed the runtime checks at all: the static fast-path
certifier (`repro_torch.analysis.certifier`) proves, from the tape and the cost-
model regime alone, that neither condition can trip — uniform lanes under a
positive per-step startup latency.  `batch_run` / `batch_run_trace` consult
it first (``certify=True``), exempt certified lanes from the guards, and
skip the guards' per-step bookkeeping entirely when the whole batch is
certified; ``BatchFabricResult.certified`` records who held a certificate.

Backends.  ``batch_run(..., backend=...)`` picks the playback engine for the
*certified* lanes:

  - ``"numpy"`` (default): the `_play` loop below — exact, guarded, no
    dependencies beyond NumPy.
  - ``"torch"``: certified lanes are played on the card by the hand-written
    CUDA kernel behind `repro_torch.core.batchsim_torch` (a lane on chip,
    on a cluster of up to 16 CTAs, at most `MAX_PORTS` ports; float64,
    bit-identical to `_play`); uncertified lanes keep the guarded
    NumPy path and its scalar-oracle fallback.  Requires ``certify=True`` —
    the kernel is guard-free, so only proven-exact lanes may enter it.
    ``device`` names where it plays: None is the card (raising without
    one), ``"cpu"`` the kernel's plain PyTorch version.
  - ``"auto"``: ``"torch"`` when a CUDA device is present (and ``device``
    does not ask for the CPU), some lane is certified, the certified work
    clears `_AUTO_MIN_WORK` and n is within the kernel's `MAX_PORTS`;
    ``"numpy"`` otherwise.  This is what the
    planner's ``fabric="ocs-sim"`` scoring uses.
  - ``"jax"`` is the reference's XLA engine and raises here.

The planner's ``fabric="ocs-sim"`` event-scores whole candidate sets through
`batch_run` in a single call; `chip_smoke.py` (phase 10) holds the card's
playback to this NumPy engine and times both.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Sequence

import numpy as np

from .bruck import step_counts
from .cost_model import CostModel
from .schedules import Schedule

if TYPE_CHECKING:  # faults imports us; only the annotation needs the type
    from .faults import FaultTimeline


def validate_rates(name: str, rates, n: int) -> list[float]:
    """Shared per-node rate-vector validation (length n, strictly positive)."""
    rates = list(rates)
    if len(rates) != n:
        raise ValueError(f"{name} has length {len(rates)} != n={n}")
    if any(v <= 0 for v in rates):
        raise ValueError(f"{name} entries must be > 0, got {rates}")
    return rates


def validate_phases(phases) -> tuple[tuple[Schedule, float], ...]:
    """Shared trace-phase validation: non-empty (schedule, m >= 0) pairs on
    one fabric (used by `TraceLane` and `FabricSim.run_trace`)."""
    phases = tuple((sched, float(m)) for sched, m in phases)
    if not phases:
        raise ValueError("a trace needs at least one (schedule, m) phase")
    n = phases[0][0].n
    for i, (sched, m) in enumerate(phases):
        if sched.n != n:
            raise ValueError(
                f"all trace phases must share one fabric: phase {i} has "
                f"n={sched.n} != {n}")
        if m < 0:
            raise ValueError(f"phase {i} payload must be >= 0, got {m}")
    return phases


@dataclasses.dataclass(frozen=True)
class FabricSnapshot:
    """Resumable fabric state at a collective boundary of a trace.

    Captured after the last phase of a (prefix) trace has fully drained
    (`FabricSim.run_trace(..., capture_state=True)` or
    `BatchTraceResult.snapshot`) and accepted back as the ``initial`` state by
    both trace engines.  The resumed run continues on the same absolute
    clock, so playing phases [0, k) and then resuming [k, P) from the
    snapshot reproduces the single full run: the sparse engine's per-port
    segment gate means prefix timings never depend on suffix traffic, and the
    boundary swap into the resumed phases is charged on top of ``port_free``
    exactly as the full run charges it.  This is what lets the online planner
    re-plan a trace suffix from the committed prefix without replaying it.

    link_offset  : circuit every egress port is left configured at (uniform —
                   ring traffic drains every port through the final segment).
    node_ready   : per node, the time its final prefix receive completed; the
                   resumed phase injects at ``node_ready[u] + alpha_s``.
    port_free    : per port, busy-until time of its last prefix service.
    chunks_moved / reconfigs_paid / delta_stall carry the prefix accounting so
    resumed results report trace-cumulative totals.
    """

    n: int
    link_offset: int
    node_ready: tuple[float, ...]
    port_free: tuple[float, ...]
    chunks_moved: int = 0
    reconfigs_paid: int = 0
    delta_stall: float = 0.0

    def __post_init__(self):
        if self.n < 2:
            raise ValueError(f"need at least 2 nodes, got n={self.n}")
        object.__setattr__(self, "node_ready",
                           tuple(float(t) for t in self.node_ready))
        object.__setattr__(self, "port_free",
                           tuple(float(t) for t in self.port_free))
        for name in ("node_ready", "port_free"):
            v = getattr(self, name)
            if len(v) != self.n:
                raise ValueError(
                    f"{name} has length {len(v)} != n={self.n}")

    @property
    def clock(self) -> float:
        """Prefix completion time (the last node's final receive)."""
        return max(self.node_ready)


# --- Tape compilation ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleTape:
    """Everything `FabricSim.run` used to rebuild per call, compiled once.

    All payload fields are m-independent: sub-step k moves
    ``m * counts[k] / n`` bytes (the exact expression the step generators
    use, so scaling is bit-identical).  Plain tuples keep the tape hashable
    and cheap for the scalar loop; `arrays` caches the NumPy views the batch
    engine indexes with.
    """

    kind: str
    n: int
    r: int
    S: int
    offsets: tuple[int, ...]        # message offset per sub-step
    counts: tuple[int, ...]         # integer block count per sub-step
    g_step: tuple[int, ...]         # link offset in force per sub-step
    hops: tuple[int, ...]           # offsets[k] // g_step[k]
    boundary: tuple[int, ...]       # schedule.x (1 = reconfigure before k)
    changed_pay: tuple[bool, ...]   # boundary k physically rewires circuits
    seg_of: tuple[int, ...]         # sub-step -> segment index
    seg_g: tuple[int, ...]          # link offset per segment
    seg_hops: tuple[int, ...]       # total hops per segment (per-port services / C)
    changed_links: tuple[int, ...]  # Schedule.reconfig_changed_links()

    @functools.cached_property
    def arrays(self) -> dict[str, np.ndarray]:
        out = {
            "offsets": np.array(self.offsets, dtype=np.int64),
            "counts": np.array(self.counts, dtype=np.float64),
            "g_step": np.array(self.g_step, dtype=np.int64),
            "hops": np.array(self.hops, dtype=np.int64),
            "changed_pay": np.array(self.changed_pay, dtype=bool),
            "boundary": np.array(self.boundary, dtype=bool),
        }
        for arr in out.values():
            arr.setflags(write=False)
        return out


@functools.lru_cache(maxsize=4096)
def compile_tape(schedule: Schedule) -> ScheduleTape:
    """Lower ``schedule`` to its playback tape (memoized per Schedule)."""
    kind, n, r = schedule.kind, schedule.n, schedule.r
    structure = step_counts(kind, n, r)
    offsets = tuple(off for off, _, _, _ in structure)
    counts = tuple(cnt for _, cnt, _, _ in structure)
    g_step = tuple(schedule.link_offsets())
    hops = tuple(off // g for off, g in zip(offsets, g_step, strict=True))
    segs = schedule.segments
    seg_of = [0] * len(offsets)
    for si, (a, b) in enumerate(segs):
        for k in range(a, b + 1):
            seg_of[k] = si
    seg_g = tuple(g_step[a] for a, _ in segs)
    seg_hops = tuple(sum(hops[a:b + 1]) for a, b in segs)
    changed_pay = tuple(
        bool(xk) and g_step[k] != g_step[k - 1]
        for k, xk in enumerate(schedule.x))
    return ScheduleTape(
        kind=kind, n=n, r=r, S=len(offsets), offsets=offsets, counts=counts,
        g_step=g_step, hops=hops, boundary=tuple(schedule.x),
        changed_pay=changed_pay, seg_of=tuple(seg_of), seg_g=seg_g,
        seg_hops=seg_hops, changed_links=schedule.reconfig_changed_links())


def clear_tape_caches() -> None:
    """Drop memoized tapes (benchmarks use this for cold-path timings)."""
    compile_tape.cache_clear()


# --- Batch configuration ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchLane:
    """One (schedule, scenario) configuration in a batch.

    delta          : reconfiguration delay override; None = cm.delta.
    overlap        : fraction of delta hidden behind communication, [0, 1].
    link_speed     : per-node relative egress rate (None = nominal).
    payload_scale  : per-destination payload multiplier (None = uniform).
    """

    schedule: Schedule
    m_bytes: float
    delta: float | None = None
    overlap: float = 0.0
    link_speed: tuple[float, ...] | None = None
    payload_scale: tuple[float, ...] | None = None

    def __post_init__(self):
        if not 0.0 <= self.overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {self.overlap}")
        if self.m_bytes < 0:
            raise ValueError(f"payload must be >= 0, got {self.m_bytes}")
        if self.delta is not None and self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        n = self.schedule.n
        for name in ("link_speed", "payload_scale"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, tuple(validate_rates(name, v, n)))
        object.__setattr__(self, "m_bytes", float(self.m_bytes))


@dataclasses.dataclass(frozen=True)
class TraceLane:
    """One (trace, scenario) configuration in a `batch_run_trace` batch.

    phases : (schedule, m_bytes) per collective, played back-to-back on one
             fabric with port-state carryover (see `FabricSim.run_trace`).
    initial: optional `FabricSnapshot` to resume from — the lane's ports
             start at the snapshot's busy-until times and configured circuit
             instead of an idle fabric, and results report trace-cumulative
             accounting.
    faults : optional `core.faults.FaultTimeline` — the lane is routed to
             the scalar fault-injecting oracle (`FabricSim.run_trace`) and
             its result carries a `DegradedState` when a fault takes effect.
    Other knobs are per-lane exactly as in `BatchLane`.
    """

    phases: tuple[tuple[Schedule, float], ...]
    delta: float | None = None
    overlap: float = 0.0
    link_speed: tuple[float, ...] | None = None
    payload_scale: tuple[float, ...] | None = None
    initial: FabricSnapshot | None = None
    faults: FaultTimeline | None = None

    def __post_init__(self):
        object.__setattr__(self, "phases", validate_phases(self.phases))
        n = self.phases[0][0].n
        if self.initial is not None and self.initial.n != n:
            raise ValueError(
                f"initial snapshot is for n={self.initial.n}, phases have "
                f"n={n}")
        if self.faults is not None and self.faults.n != n:
            raise ValueError(
                f"fault timeline is for n={self.faults.n}, phases have "
                f"n={n}")
        if not 0.0 <= self.overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {self.overlap}")
        if self.delta is not None and self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        for name in ("link_speed", "payload_scale"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, tuple(validate_rates(name, v, n)))

    @property
    def n(self) -> int:
        return self.phases[0][0].n


@dataclasses.dataclass(frozen=True)
class BatchFabricResult:
    """Outcome of one `batch_run`: `FabricResult` fields with a lane axis.

    fast_path[b] is True when lane b completed on the vectorized tape
    playback and False when it was re-run through the scalar oracle (the
    canonical-order check tripped, e.g. under a severe straggler).
    certified[b] is True when lane b held a static fast-path certificate
    (`repro_torch.analysis.certifier`): its exactness was proven from the tape and
    regime alone, without running the runtime guards.  certified implies
    fast_path.
    backend is the resolved playback engine ("numpy" or "torch"); under
    "torch" the certified lanes ran on the CUDA kernel (or its plain version
    on the CPU) and the uncertified ones on the guarded NumPy path (timing
    output is identical either way).
    """

    completion: np.ndarray      # [B]
    node_done: np.ndarray       # [B, n]
    step_done: np.ndarray       # [B, S]
    chunks_moved: np.ndarray    # [B] int
    reconfigs_paid: np.ndarray  # [B] int
    delta_stall: np.ndarray     # [B]
    fast_path: np.ndarray       # [B] bool
    certified: np.ndarray       # [B] bool
    lanes: tuple[BatchLane, ...]
    backend: str = "numpy"

    def __len__(self) -> int:
        return len(self.lanes)

    def result(self, i: int):
        """Lane i as a scalar-compatible `FabricResult` (mode='batched')."""
        from .fabricsim import FabricResult  # deferred: fabricsim imports us

        tape = compile_tape(self.lanes[i].schedule)
        return FabricResult(
            completion=float(self.completion[i]), mode="batched",
            step_done=tuple(float(t) for t in self.step_done[i]),
            node_done=tuple(float(t) for t in self.node_done[i]),
            chunks_moved=int(self.chunks_moved[i]),
            changed_links=tape.changed_links,
            reconfigs_paid=int(self.reconfigs_paid[i]),
            delta_stall=float(self.delta_stall[i]))


# --- Batched playback ---------------------------------------------------------


def _knob_arrays(lanes, cm: CostModel, n: int):
    """Per-lane delta/overlap/speed/scale arrays shared by both entry points."""
    B = len(lanes)
    delta = np.array([cm.delta if lane.delta is None else lane.delta
                      for lane in lanes])
    overlap = np.array([lane.overlap for lane in lanes])
    delta_eff = delta * (1.0 - overlap)
    speed = np.ones((B, n))
    for b, lane in enumerate(lanes):
        if lane.link_speed is not None:
            speed[b] = lane.link_speed
    scale = None
    if any(lane.payload_scale is not None for lane in lanes):
        scale = np.ones((B, n))
        for b, lane in enumerate(lanes):
            if lane.payload_scale is not None:
                scale[b] = lane.payload_scale
    return delta, overlap, delta_eff, speed, scale


def _play(*, n: int, C: int, cm: CostModel, nb_step, g_step, hops, boundary,
          changed, delta_eff, speed, scale, F0=None, ready0=None,
          changed0=None, check_order: bool = True):
    """Canonical-order tape playback over [B, S] step arrays.

    ``nb_step[b, k]`` is lane b's per-node payload of sub-step k (before any
    destination scaling); ``boundary`` marks steps that open a new segment
    (the scalar loop's per-port segment gate resets there) and ``changed``
    marks steps whose opening boundary physically rewires circuits (those
    charge ``delta_eff``).  ``F0`` / ``ready0`` / ``changed0`` resume lanes
    from a `FabricSnapshot`: per-port busy-until times, per-node final
    receive times of the committed prefix (step 0 injects at
    ``ready0 + alpha_s``), and the per-lane flag for an entry boundary that
    rewires circuits (charged like any segment boundary).  Returns
    (node_done, step_done, ok, port_free) where ``ok`` flags the lanes whose
    heap execution provably coincides with this canonical order (see module
    docstring) and ``port_free`` is the final per-port busy-until state.

    ``check_order=False`` skips the runtime canonical-order guards and their
    ``first_arr`` / ``last_arr`` / ``seg_max_arr`` bookkeeping entirely and
    returns ``ok`` all-True — only valid when every lane in the batch holds
    a static fast-path certificate (`repro_torch.analysis.certifier`), which
    proves the guards could not have tripped.  The timing arrays are
    bit-identical either way: the guards observe the timeline, they never
    alter it.
    """
    B, S = nb_step.shape
    alpha_s, alpha_h, beta = cm.alpha_s, cm.alpha_h, cm.beta
    ports = np.arange(n, dtype=np.int64)[None, :]           # [1, n]

    # port busy-until / injection times of the current step, warm-started
    # from the snapshot arrays in the same float-op order as the scalar
    # restore (free = port_free [+ delta_eff]; t_inj = node_ready + alpha_s)
    F = np.zeros((B, n)) if F0 is None else np.array(F0, dtype=float)
    if changed0 is not None:
        F = F + np.where(changed0, delta_eff, 0.0)[:, None]
    inj = (np.full((B, n), alpha_s) if ready0 is None
           else np.asarray(ready0, dtype=float) + alpha_s)
    step_done = np.zeros((B, S))
    ok = np.ones(B, dtype=bool)       # canonical-order check per lane
    if check_order:
        seg_max_arr = np.full((B, n), -np.inf)  # latest arrival this segment

    for k in range(S):
        if k > 0:
            inj = recv + alpha_s
            F = F + np.where(changed[:, k], delta_eff, 0.0)[:, None]
        h = hops[:, k]                                       # [B]
        g = g_step[:, k]                                     # [B]
        nb = nb_step[:, k]                                   # [B]
        gather_idx = (ports - g[:, None]) % n                # [B, n]
        gather_idx3 = np.broadcast_to(gather_idx[:, :, None], (B, n, C))
        arr = np.broadcast_to(inj[:, :, None], (B, n, C))    # stream-0 arrivals
        if check_order:
            first_arr, last_arr = inj.copy(), inj.copy()     # min/max over streams
        recv = np.empty((B, n))
        comp = np.empty((B, n, C))
        for j in range(int(h.max())):
            active = j < h                                   # [B]
            # per-port service time of this hop stream (scalar op order:
            # ((nbytes [* dest scale]) / C) * beta / speed)
            if scale is None:
                nbw = np.broadcast_to(nb[:, None], (B, n))
            else:
                dest = (ports + ((h - j) * g)[:, None]) % n
                nbw = nb[:, None] * np.take_along_axis(scale, dest, axis=1)
            tau = (nbw / C) * beta / speed
            f = F
            for c in range(C):
                f = np.maximum(f, arr[:, :, c]) + tau
                comp[:, :, c] = f
            F = np.where(active[:, None], f, F)
            nxt = np.take_along_axis(comp, gather_idx3, axis=1) + alpha_h
            final = active & (j + 1 >= h)
            if final.any():
                deliver = np.take_along_axis(comp[:, :, C - 1],
                                             gather_idx, axis=1) + alpha_h
                recv = np.where(final[:, None], deliver, recv)
            cont = active & (j + 1 < h)
            if not cont.any():
                break
            if check_order:
                if j == 0:
                    # a hop-1 chunk overtaking the port's own injection breaks
                    # the canonical within-step stream order
                    ok &= ~(cont & (nxt[:, :, 0] <= inj).any(axis=1))
                first_arr = np.where(cont[:, None],
                                     np.minimum(first_arr, nxt[:, :, 0]),
                                     first_arr)
                last_arr = np.where(cont[:, None],
                                    np.maximum(last_arr, nxt[:, :, C - 1]),
                                    last_arr)
            arr = nxt
        if check_order:
            # canonical cross-step order within a segment: step k's first
            # arrivals must not precede (or tie with) any earlier arrival at
            # the same port — the scalar loop's segment gate covers
            # boundaries, so the running max resets there
            if k > 0:
                same_seg = ~boundary[:, k]
                ok &= ~(same_seg & (first_arr <= seg_max_arr).any(axis=1))
            reset = boundary[:, k][:, None]
            seg_max_arr = np.where(reset, last_arr,
                                   np.maximum(seg_max_arr, last_arr))
        step_done[:, k] = recv.max(axis=1)
    return recv, step_done, ok, F


# "auto" switches to the card's playback only above this estimated certified
# work, in chunk-services (C * n * total certified hops).  Below it NumPy's
# loop may cost less than the kernel's launch, the tape copies and the host
# round trip.  The value is the crossover `chip_smoke.py` (phase 10)
# measured on an H100: whole batch_run calls on the planner's candidate sets
# (C = 8) were faster on the card from n = 6 (2,208 chunk-services, 0.43
# against 0.83 ms) at every size up to n = 384 (PERF.md).
_AUTO_MIN_WORK = 2e3


def _resolve_backend(backend: str, *, certify: bool, certified: np.ndarray,
                     n: int, C: int, hops: np.ndarray, device=None) -> str:
    """Resolve a ``backend=`` request to the engine that will actually run.

    "torch" demands ``certify=True`` (the CUDA kernel is guard-free — only
    certified lanes may enter it) but degrades to "numpy" when no lane in
    *this* batch is certified, since there would be nothing for the kernel
    to do.  "auto" additionally requires a CUDA device and the certified
    work to clear `_AUTO_MIN_WORK`, so small batches keep NumPy's lower
    fixed cost, and n within the kernel's `MAX_PORTS` (its clocks on chip).
    """
    if backend == "jax":
        raise ValueError(
            "backend='jax' is the reference's XLA engine; the port plays "
            "certified lanes on the card with backend='torch'")
    if backend not in ("numpy", "torch", "auto"):
        raise ValueError(
            f"backend must be 'numpy', 'torch', or 'auto', got {backend!r}")
    if backend == "numpy":
        return "numpy"
    if not certify:
        if backend == "torch":
            raise ValueError(
                "backend='torch' requires certify=True: the CUDA fast path is "
                "guard-free and only sound for lanes holding a static "
                "fast-path certificate")
        return "numpy"
    if backend == "torch":
        return "torch" if bool(certified.any()) else "numpy"
    # auto: opt in only when the card exists and the certified work amortizes it
    from repro_torch.kernels.playback.kernel import MAX_PORTS

    from .batchsim_torch import cuda_available

    if not cuda_available(device) or not bool(certified.any()) or n > MAX_PORTS:
        return "numpy"
    work = float(C) * n * float(hops[certified].sum())
    return "torch" if work >= _AUTO_MIN_WORK else "numpy"


def batch_run(lanes: Sequence[BatchLane], cm: CostModel, *,
              chunks_per_msg: int = 32, allow_fallback: bool = True,
              certify: bool = True, backend: str = "numpy",
              device=None) -> BatchFabricResult:
    """Play every lane's tape forward together (sparse-fabric semantics).

    All lanes must share the same world size n and sub-step count S (any mix
    of collectives / segmentations at one (n, r) qualifies — including the
    RS and AG phases of an AllReduce).  Set ``allow_fallback=False`` to get a
    RuntimeError instead of the scalar re-run when a lane's canonical-order
    check trips (used by tests to prove the fast path was exercised).

    ``certify=True`` (the default) consults the static fast-path certifier
    first: lanes whose (schedule, regime) certificate proves the canonical-
    order guards cannot trip are exempt from them, and when *every* lane is
    certified the guards' per-step bookkeeping is skipped outright.  Timing
    output is bit-identical with ``certify=False`` — the certificate only
    decides whether the guards need to watch.

    ``backend`` selects the playback engine for the certified lanes:
    ``"numpy"`` (default), ``"torch"`` (the CUDA kernel on ``device``,
    requires ``certify=True``), or ``"auto"`` (the card when present and
    worthwhile).  Uncertified lanes always run the guarded NumPy path
    regardless of backend; see the module docstring.
    """
    lanes = tuple(lanes)
    if not lanes:
        raise ValueError("batch_run needs at least one lane")
    tapes = [compile_tape(lane.schedule) for lane in lanes]
    n, S = tapes[0].n, tapes[0].S
    for lane, tape in zip(lanes, tapes, strict=True):
        if tape.n != n or tape.S != S:
            raise ValueError(
                f"all lanes must share (n, S); got ({tape.n}, {tape.S}) for "
                f"{lane.schedule.kind} vs ({n}, {S})")
    C = max(1, int(chunks_per_msg))

    m = np.array([lane.m_bytes for lane in lanes])
    delta, overlap, delta_eff, speed, scale = _knob_arrays(lanes, cm, n)

    # --- per-lane tape arrays [B, S] ---------------------------------------
    counts = np.stack([t.arrays["counts"] for t in tapes])
    g_step = np.stack([t.arrays["g_step"] for t in tapes])
    hops = np.stack([t.arrays["hops"] for t in tapes])
    boundary = np.stack([t.arrays["boundary"] for t in tapes])
    changed = np.stack([t.arrays["changed_pay"] for t in tapes])
    nb_step = (m[:, None] * counts) / n   # same float-op order as the scalar loop

    if certify:
        from repro_torch.analysis.certifier import certify_batch  # no cycle: analysis imports core only

        certified = certify_batch(lanes, cm)
    else:
        certified = np.zeros(len(lanes), dtype=bool)

    backend = _resolve_backend(backend, certify=certify, certified=certified,
                               n=n, C=C, hops=hops, device=device)
    if backend == "torch":
        # certified lanes -> guard-free CUDA kernel; the rest keep the
        # guarded NumPy playback (and below, its scalar-oracle fallback)
        from .batchsim_torch import play_certified

        B = len(lanes)
        jidx = np.flatnonzero(certified)
        uidx = np.flatnonzero(~certified)
        node_done = np.empty((B, n))
        step_done = np.empty((B, S))
        ok = np.ones(B, dtype=bool)
        nd_j, sd_j, _ = play_certified(
            n=n, C=C, cm=cm, nb_step=nb_step[jidx], g_step=g_step[jidx],
            hops=hops[jidx], changed=changed[jidx], delta_eff=delta_eff[jidx],
            device=device)
        node_done[jidx] = nd_j
        step_done[jidx] = sd_j
        if uidx.size:
            nd_u, sd_u, ok_u, _ = _play(
                n=n, C=C, cm=cm, nb_step=nb_step[uidx], g_step=g_step[uidx],
                hops=hops[uidx], boundary=boundary[uidx],
                changed=changed[uidx], delta_eff=delta_eff[uidx],
                speed=speed[uidx],
                scale=scale[uidx] if scale is not None else None,
                check_order=True)
            node_done[uidx] = nd_u
            step_done[uidx] = sd_u
            ok[uidx] = ok_u
    else:
        node_done, step_done, ok, _ = _play(
            n=n, C=C, cm=cm, nb_step=nb_step, g_step=g_step, hops=hops,
            boundary=boundary, changed=changed, delta_eff=delta_eff,
            speed=speed, scale=scale, check_order=not bool(certified.all()))
    ok |= certified  # certified lanes are exact by proof, not by observation

    completion = node_done.max(axis=1)
    n_changed = changed.sum(axis=1)
    reconfigs_paid = (n * n_changed).astype(np.int64)
    delta_stall = reconfigs_paid * delta_eff
    chunks_moved = (n * C * hops.sum(axis=1)).astype(np.int64)

    if not ok.all():
        if not allow_fallback:
            raise RuntimeError(
                f"canonical-order check tripped for lanes "
                f"{np.flatnonzero(~ok).tolist()} and fallback is disabled")
        from .fabricsim import FabricSim  # deferred: fabricsim imports us

        for b in np.flatnonzero(~ok):
            lane = lanes[b]
            sim = FabricSim(
                chunks_per_msg=C, overlap=float(overlap[b]), mode="sparse",
                link_speed=(list(lane.link_speed)
                            if lane.link_speed is not None else None),
                payload_scale=(list(lane.payload_scale)
                               if lane.payload_scale is not None else None))
            res = sim.run(lane.schedule, float(m[b]),
                          cm.replace(delta=float(delta[b])))
            completion[b] = res.completion
            node_done[b] = res.node_done
            step_done[b] = res.step_done
            chunks_moved[b] = res.chunks_moved
            reconfigs_paid[b] = res.reconfigs_paid
            delta_stall[b] = res.delta_stall

    return BatchFabricResult(
        completion=completion, node_done=node_done, step_done=step_done,
        chunks_moved=chunks_moved, reconfigs_paid=reconfigs_paid,
        delta_stall=delta_stall, fast_path=ok, certified=certified,
        lanes=lanes, backend=backend)


@dataclasses.dataclass(frozen=True)
class BatchTraceResult:
    """Outcome of one `batch_run_trace`: `TraceFabricResult` fields + lane axis."""

    completion: np.ndarray      # [B]
    node_done: np.ndarray       # [B, n]
    step_done: np.ndarray       # [B, S_total]
    phase_done: np.ndarray      # [B, P]
    chunks_moved: np.ndarray    # [B] int
    reconfigs_paid: np.ndarray  # [B] int
    delta_stall: np.ndarray     # [B]
    fast_path: np.ndarray       # [B] bool
    certified: np.ndarray       # [B] bool (static fast-path certificate held)
    port_free: np.ndarray       # [B, n] final per-port busy-until
    lanes: tuple[TraceLane, ...]
    degraded: tuple = ()        # [B] DegradedState | None (faulted lanes)

    def __len__(self) -> int:
        return len(self.lanes)

    def snapshot(self, i: int) -> FabricSnapshot:
        """Lane i's resumable end-of-trace fabric state."""
        lane = self.lanes[i]
        if self.degraded and self.degraded[i] is not None:
            raise ValueError(
                f"lane {i} ended degraded (a fault took effect); its "
                f"resumable state is the committed-prefix snapshot at "
                f"result({i}).degraded.snapshot")
        return FabricSnapshot(
            n=lane.n,
            link_offset=lane.phases[-1][0].link_offsets()[-1],
            node_ready=tuple(float(t) for t in self.node_done[i]),
            port_free=tuple(float(t) for t in self.port_free[i]),
            chunks_moved=int(self.chunks_moved[i]),
            reconfigs_paid=int(self.reconfigs_paid[i]),
            delta_stall=float(self.delta_stall[i]))

    def result(self, i: int):
        """Lane i as a scalar-compatible `TraceFabricResult` (mode='batched')."""
        # deferred: fabricsim imports us
        from .fabricsim import TraceFabricResult, trace_boundary_changed

        return TraceFabricResult(
            completion=float(self.completion[i]), mode="batched",
            phase_done=tuple(float(t) for t in self.phase_done[i]),
            step_done=tuple(float(t) for t in self.step_done[i]),
            node_done=tuple(float(t) for t in self.node_done[i]),
            chunks_moved=int(self.chunks_moved[i]),
            boundary_changed=trace_boundary_changed(
                [sched for sched, _ in self.lanes[i].phases]),
            reconfigs_paid=int(self.reconfigs_paid[i]),
            delta_stall=float(self.delta_stall[i]),
            degraded=self.degraded[i] if self.degraded else None)


def batch_run_trace(lanes: Sequence[TraceLane], cm: CostModel, *,
                    chunks_per_msg: int = 32, allow_fallback: bool = True,
                    certify: bool = True) -> BatchTraceResult:
    """Play every lane's trace forward together with fabric-state carryover.

    Each lane's phases are concatenated into one tape: a collective boundary
    is exactly a segment boundary (the next phase's injections chain off each
    node's own final receive of the previous phase, ports keep draining), and
    it charges the lane's effective delta only when the initial link offset
    of phase p+1 differs from the final one of phase p.  All lanes must share
    the same world size n and per-phase sub-step counts.  Lanes whose
    canonical-order check trips are re-run through the scalar
    `FabricSim.run_trace` oracle unless ``allow_fallback=False``.
    ``certify`` engages the static fast-path certifier exactly as in
    `batch_run` (snapshot-resumed lanes are never certified — the restored
    per-port state breaks the rotational symmetry the certificate needs).

    Lanes carrying a `TraceLane.faults` timeline always route to the scalar
    fault-injecting oracle (they are never certified and never fast-path —
    the vectorized playback has no notion of a mid-trace world change) and
    their `DegradedState` lands in ``BatchTraceResult.degraded``; such
    lanes therefore require ``allow_fallback=True``.
    """
    lanes = tuple(lanes)
    if not lanes:
        raise ValueError("batch_run_trace needs at least one lane")
    tapes = [[compile_tape(sched) for sched, _ in lane.phases] for lane in lanes]
    n = tapes[0][0].n
    shape = tuple(t.S for t in tapes[0])
    for _lane, ts in zip(lanes, tapes, strict=True):
        if ts[0].n != n or tuple(t.S for t in ts) != shape:
            raise ValueError(
                f"all trace lanes must share (n, per-phase S); got "
                f"({ts[0].n}, {tuple(t.S for t in ts)}) vs ({n}, {shape})")
    B, P, S = len(lanes), len(shape), sum(shape)
    C = max(1, int(chunks_per_msg))
    phase_start = np.cumsum((0,) + shape[:-1])
    phase_last = np.cumsum(shape) - 1

    delta, overlap, delta_eff, speed, scale = _knob_arrays(lanes, cm, n)

    # --- concatenated per-lane tape arrays [B, S] --------------------------
    g_step = np.stack([np.concatenate([t.arrays["g_step"] for t in ts])
                       for ts in tapes])
    hops = np.stack([np.concatenate([t.arrays["hops"] for t in ts])
                     for ts in tapes])
    boundary = np.stack([np.concatenate([t.arrays["boundary"] for t in ts])
                         for ts in tapes])
    changed = np.stack([np.concatenate([t.arrays["changed_pay"] for t in ts])
                        for ts in tapes])
    nb_step = np.stack([
        np.concatenate([(m * t.arrays["counts"]) / n
                        for (_, m), t in zip(lane.phases, ts, strict=True)])
        for lane, ts in zip(lanes, tapes, strict=True)])
    # a phase start opens a new segment (gate reset) and rewires only the
    # circuits that differ from the previous phase's final configuration
    for k in phase_start[1:]:
        boundary[:, k] = True
        changed[:, k] = g_step[:, k] != g_step[:, k - 1]

    # resumed lanes start from their snapshot's port state; entering the
    # first phase is then a boundary like any other (rewire iff the resumed
    # phase's initial offset differs from the snapshot's)
    F0 = ready0 = changed0 = None
    init_chunks = np.zeros(B, dtype=np.int64)
    init_paid = np.zeros(B, dtype=np.int64)
    init_stall = np.zeros(B)
    if any(lane.initial is not None for lane in lanes):
        F0, ready0 = np.zeros((B, n)), np.zeros((B, n))
        changed0 = np.zeros(B, dtype=bool)
        for b, lane in enumerate(lanes):
            snap = lane.initial
            if snap is None:
                continue
            F0[b] = snap.port_free
            ready0[b] = snap.node_ready
            changed0[b] = int(g_step[b, 0]) != snap.link_offset
            init_chunks[b] = snap.chunks_moved
            init_paid[b] = snap.reconfigs_paid
            init_stall[b] = snap.delta_stall

    faulted = np.array([lane.faults is not None for lane in lanes])
    if faulted.any() and not allow_fallback:
        raise ValueError(
            f"fault-injecting trace lanes {np.flatnonzero(faulted).tolist()} "
            f"require allow_fallback=True: faulted lanes always route to "
            f"the scalar oracle")

    if certify:
        from repro_torch.analysis.certifier import certify_trace_batch  # no cycle

        certified = certify_trace_batch(lanes, cm)
    else:
        certified = np.zeros(B, dtype=bool)
    certified &= ~faulted  # a certificate cannot cover a mid-trace fault

    node_done, step_done, ok, port_free = _play(
        n=n, C=C, cm=cm, nb_step=nb_step, g_step=g_step, hops=hops,
        boundary=boundary, changed=changed, delta_eff=delta_eff,
        speed=speed, scale=scale, F0=F0, ready0=ready0, changed0=changed0,
        check_order=not bool(certified.all()))
    ok |= certified  # certified lanes are exact by proof, not by observation
    ok &= ~faulted   # force faulted lanes through the scalar oracle

    completion = node_done.max(axis=1)
    phase_done = step_done[:, phase_last]
    paid_run = n * (changed.sum(axis=1)
                    + (changed0 if changed0 is not None else 0))
    reconfigs_paid = (paid_run + init_paid).astype(np.int64)
    delta_stall = paid_run * delta_eff + init_stall
    chunks_moved = (n * C * hops.sum(axis=1) + init_chunks).astype(np.int64)

    degraded_list: list = [None] * B
    if not ok.all():
        if not allow_fallback:
            raise RuntimeError(
                f"canonical-order check tripped for trace lanes "
                f"{np.flatnonzero(~ok).tolist()} and fallback is disabled")
        from .fabricsim import FabricSim  # deferred: fabricsim imports us

        for b in np.flatnonzero(~ok):
            lane = lanes[b]
            sim = FabricSim(
                chunks_per_msg=C, overlap=float(overlap[b]), mode="sparse",
                link_speed=(list(lane.link_speed)
                            if lane.link_speed is not None else None),
                payload_scale=(list(lane.payload_scale)
                               if lane.payload_scale is not None else None))
            res = sim.run_trace(lane.phases, cm.replace(delta=float(delta[b])),
                                initial=lane.initial, capture_state=True,
                                faults=lane.faults)
            completion[b] = res.completion
            node_done[b] = res.node_done
            step_done[b] = res.step_done
            phase_done[b] = res.phase_done
            chunks_moved[b] = res.chunks_moved
            reconfigs_paid[b] = res.reconfigs_paid
            delta_stall[b] = res.delta_stall
            degraded_list[b] = res.degraded
            if res.final_state is not None:
                port_free[b] = res.final_state.port_free
            else:
                # degraded before any boundary with no initial snapshot:
                # nothing committed, no resumable port state
                port_free[b] = np.inf

    return BatchTraceResult(
        completion=completion, node_done=node_done, step_done=step_done,
        phase_done=phase_done, chunks_moved=chunks_moved,
        reconfigs_paid=reconfigs_paid, delta_stall=delta_stall,
        fast_path=ok, certified=certified, port_free=port_free, lanes=lanes,
        degraded=tuple(degraded_list))


def batch_completion_times(schedules: Sequence[Schedule], m: float,
                           cm: CostModel, *, overlap: float = 0.0,
                           chunks_per_msg: int = 32,
                           backend: str = "numpy", device=None) -> np.ndarray:
    """Event-level completion time of every schedule in one batched call.

    The planner's ``fabric='ocs-sim'`` scoring primitive: all schedules share
    (n, S) — e.g. one request's full candidate set — and the same payload /
    cost model / overlap credit.  ``backend`` and ``device`` are forwarded
    to `batch_run` (the planner passes ``"auto"`` so wide candidate sets
    score on the card when it is present).
    """
    lanes = [BatchLane(schedule=s, m_bytes=m, overlap=overlap)
             for s in schedules]
    return batch_run(lanes, cm, chunks_per_msg=chunks_per_msg,
                     backend=backend, device=device).completion

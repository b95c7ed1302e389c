"""BRIDGE reconfiguration-schedule synthesis (paper Sections 3.3-3.6),
generalized to arbitrary world sizes n and radix r.

A schedule for an S-sub-step Bruck collective is x in {0,1}^S, x_k = 1
meaning the OCS is reconfigured immediately before sub-step k.  x_0 = 0
always: the initial topology is established before the collective starts
(the physical ring for All-to-All / Reduce-Scatter; the first segment's
subring for AllGather, paper Section 3.5) and is therefore free.

Equivalently a schedule is a partition of the sub-steps 0..S-1 into R+1
contiguous *segments*; the topology is reconfigured at each segment boundary
and *reused* within a segment.  The OCS link offset of a segment is the
greatest common divisor of the Bruck message offsets inside it, so that
every step in the segment stays inside its subring (generalized Lemma 3.2:
a destination is reachable iff the message offset is divisible by the link
offset).  For radix 2 the offsets in a segment are successive powers of two
and the gcd is the smallest offset — exactly the paper's rule.

  - All-to-All:      optimal segments are balanced (Lemma 3.1 / Theorem 3.2)
                     => periodic reconfigurations.
  - Reduce-Scatter:  transmission-optimal segments are found by an interval
                     partition DP (the paper's ILP, Theorem 3.3) => early.
  - AllGather:       the time-reverse of Reduce-Scatter => late (Section 3.5).
  - Optimal R:       argmin over 0 <= R < S of modeled completion time (3.6).

All DPs below score segments with the *actual* per-sub-step hop counts and
send volumes from `bruck.steps_for`, so they remain exact for non-power-of-
two n and radix r > 2 where the paper's closed forms (2^len - 1, len / 2^a)
no longer apply.  For power-of-two n at radix 2 the synthesized schedules
are bit-identical to the paper's Table 1 (tested).

One DP table pass fills the optimum for *every* segment count at once
(`best[i][r]` is already computed for all r), and `SegmentTables` makes the
per-segment cost O(1) via prefix sums plus a dense interval-gcd table, so a
full candidate set over all R costs one O(S^3) DP per strategy family
instead of S separate capped DPs (~S/4 x fewer cell relaxations; counted by
`dp_stats` and pinned in BENCH_planner.json).

Planning entry point: `repro.planner` (PlanRequest -> Planner -> PlanResult).
The module-level `plan` / `candidate_schedules` here are kept as thin
deprecated shims over it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

from .bruck import (Collective, Step, is_pow2, num_steps, schedule_length,
                    steps_for)
from .cost_model import CostModel


def _segment_gcd(steps: Sequence[Step], a: int, b: int) -> int:
    """Link offset of segment [a, b]: gcd of its message offsets."""
    g = 0
    for j in range(a, b + 1):
        g = math.gcd(g, steps[j].offset)
    return g


def changed_links(n: int, prev: int | Sequence[int],
                  nxt: int | Sequence[int]) -> int:
    """Egress circuits that physically differ between two link configurations.

    ``prev`` and ``nxt`` each describe the configured circuit of every node's
    optical egress port, either as one uniform subring link offset (an int:
    node u targets (u + g) mod n) or as a per-node offset sequence of length
    n.  Returns how many of the n egress circuits target a different node
    under ``nxt`` than under ``prev`` — the circuits an OCS must rewire to
    move between the configurations; everything else keeps carrying traffic.

    This is the free-function generalization of
    `Schedule.reconfig_changed_links` (which diffs consecutive segments of a
    single schedule): it applies to *any* boundary between two link states,
    in particular the boundary between back-to-back collectives in a workload
    trace, where the fabric's final offsets from collective i are the initial
    configuration of collective i+1 (`repro.workloads.trace_planner`).
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")

    def norm(name: str, v) -> tuple[int, ...]:
        if isinstance(v, int):
            return (v % n,) * n
        v = tuple(int(g) % n for g in v)
        if len(v) != n:
            raise ValueError(f"{name} has {len(v)} per-node offsets != n={n}")
        return v

    if isinstance(prev, int) and isinstance(nxt, int):
        return 0 if prev % n == nxt % n else n
    return sum(1 for a, b in zip(norm("prev", prev), norm("nxt", nxt),
                                 strict=True) if a != b)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Reconfiguration schedule for one collective execution.

    ``r`` is the Bruck radix the sub-step sequence was generated with
    (r = 2 is the paper's pattern; r > 2 is the multiport/radix-r
    generalization of Section 3.1).
    """

    kind: Collective
    n: int
    x: tuple[int, ...]
    r: int = 2

    def __post_init__(self):
        s = schedule_length(self.kind, self.n, self.r)
        if len(self.x) != s:
            raise ValueError(
                f"schedule length {len(self.x)} != S={s} (n={self.n}, r={self.r})")
        if any(v not in (0, 1) for v in self.x):
            raise ValueError("x must be 0/1")
        if self.x and self.x[0] != 0:
            raise ValueError("x_0 must be 0: initial topology is pre-established")

    @property
    def R(self) -> int:
        return sum(self.x)

    @property
    def segments(self) -> tuple[tuple[int, int], ...]:
        """Inclusive (first_step, last_step) per reconfiguration period."""
        s = len(self.x)
        bounds = [k for k in range(s) if self.x[k] == 1] + [s]
        segs, a = [], 0
        for b in bounds:
            segs.append((a, b - 1))
            a = b
        return tuple(segs)

    def link_offsets(self, steps: Sequence[Step] | None = None) -> list[int]:
        """OCS link offset in force during each sub-step.

        The offsets depend only on (kind, n, x, r) — never on the payload —
        so the default path is memoized per schedule (`_link_offsets_cached`);
        a fresh list is returned either way.
        """
        if steps is None:
            return list(_link_offsets_cached(self))
        out = [0] * len(self.x)
        for a, b in self.segments:
            g = _segment_gcd(steps, a, b)
            for j in range(a, b + 1):
                out[j] = g
        return out

    def reconfig_changed_links(self, steps: Sequence[Step] | None = None) -> tuple[int, ...]:
        """Circuits that physically change at each reconfiguration point.

        Entry i corresponds to the i-th set bit of ``x`` (the boundary before
        segment i+1) and is the number of egress circuits whose target
        differs between the adjacent segments' link offsets.  Under
        uniform-offset subrings every node's egress retargets when the
        offset changes, so each entry is ``n`` (all circuits) or ``0`` (the
        boundary reuses the same offset — possible for duplicate-gcd
        segments, e.g. at radix r > 2).  FabricSim and the overlap-aware
        analytic model charge delta only where an entry is nonzero.
        """
        if steps is None:
            return _changed_links_cached(self)
        gs = [_segment_gcd(steps, a, b) for a, b in self.segments]
        return tuple(changed_links(self.n, gs[i - 1], gs[i])
                     for i in range(1, len(gs)))

    @staticmethod
    def from_segments(kind: Collective, n: int, lengths: Sequence[int],
                      r: int = 2) -> "Schedule":
        s = schedule_length(kind, n, r)
        if sum(lengths) != s or any(seg_len <= 0 for seg_len in lengths):
            raise ValueError(f"segment lengths {lengths} must be positive and sum to {s}")
        x = [0] * s
        pos = 0
        for seg_len in lengths[:-1]:
            pos += seg_len
            x[pos] = 1
        return Schedule(kind=kind, n=n, x=tuple(x), r=r)

    @property
    def segment_lengths(self) -> tuple[int, ...]:
        return tuple(b - a + 1 for a, b in self.segments)


def static_schedule(kind: Collective, n: int, r: int = 2) -> Schedule:
    return Schedule(kind=kind, n=n, x=tuple([0] * schedule_length(kind, n, r)), r=r)


def every_step_schedule(kind: Collective, n: int, r: int = 2) -> Schedule:
    """Greedy (G-BRUCK-like): reconfigure before every sub-step after the first."""
    s = schedule_length(kind, n, r)
    return Schedule(kind=kind, n=n, x=tuple([0] + [1] * (s - 1)), r=r)


# --- Generic segment-partition DP -------------------------------------------

#: Cumulative DP work counters since the last `reset_dp_stats()`.
#: ``relaxations`` counts inner-loop cell relaxations (one candidate previous
#: boundary examined); ``dp_calls`` counts DP table constructions.  The
#: planner benchmark (benchmarks/planner_bench.py) uses these to certify the
#: all-R single-pass speedup recorded in BENCH_planner.json.
_DP_STATS = {"dp_calls": 0, "relaxations": 0}


def dp_stats() -> dict:
    """Snapshot of the DP work counters (see `reset_dp_stats`)."""
    return dict(_DP_STATS)


def reset_dp_stats() -> None:
    _DP_STATS["dp_calls"] = 0
    _DP_STATS["relaxations"] = 0


def _dp_table(
    s: int, max_segments: int, seg_cost: Callable[[int, int], float]
) -> list[list[tuple[float, tuple[int, ...]]]]:
    """Fill best[i][r] = (cost, lengths) covering steps 0..i-1 with exactly r
    segments, for every r <= max_segments — the all-R workhorse.

    Ties are broken toward lexicographically-smallest segment-length tuples,
    which matches the paper's Table 1 presentation.
    """
    INF = float("inf")
    best: list[list[tuple[float, tuple[int, ...]]]] = [
        [(INF, ())] * (max_segments + 1) for _ in range(s + 1)
    ]
    best[0][0] = (0.0, ())
    relaxations = 0
    for i in range(1, s + 1):
        for r in range(1, min(i, max_segments) + 1):
            cand = (INF, ())
            for a in range(r - 1, i):  # previous boundary
                prev_cost, prev_lens = best[a][r - 1]
                if prev_cost == INF:
                    continue
                relaxations += 1
                c = prev_cost + seg_cost(a, i - 1)
                key = (c, prev_lens + (i - a,))
                if key < cand:
                    cand = key
            best[i][r] = cand
    _DP_STATS["dp_calls"] += 1
    _DP_STATS["relaxations"] += relaxations
    return best


def _partition_dp(
    s: int, num_segments: int, seg_cost: Callable[[int, int], float]
) -> tuple[float, list[int]]:
    """Minimize sum of seg_cost(a, b) over partitions of 0..s-1 into exactly
    ``num_segments`` contiguous segments.  Returns (cost, segment lengths).

    Single-R entry point (the legacy per-R reference path runs this once per
    R); `_partition_dp_all` extracts every segment count from one table.
    """
    if not (1 <= num_segments <= s):
        raise ValueError(f"need 1 <= segments={num_segments} <= s={s}")
    cost, lens = _dp_table(s, num_segments, seg_cost)[s][num_segments]
    if cost == float("inf"):
        raise RuntimeError("infeasible partition")
    return cost, list(lens)


def _partition_dp_all(
    s: int, seg_cost: Callable[[int, int], float]
) -> list[tuple[float, tuple[int, ...]]]:
    """One DP pass, optima for *every* number of segments 1..s.

    Returns a list indexed by R = num_segments - 1 of (cost, lengths); entry
    R is bit-identical to `_partition_dp(s, R + 1, seg_cost)` because
    best[i][r] never depends on the segment-count cap.
    """
    best = _dp_table(s, s, seg_cost)
    return [best[s][r] for r in range(1, s + 1)]


class SegmentTables:
    """O(1) segment costs for a fixed step sequence.

    Precomputes an O(S^2) dense interval-gcd table plus prefix sums of the
    message offsets and of nbytes * offset.  Because the segment link offset
    g = gcd(offsets in [a, b]) divides every offset in the segment,

        sum_j offset_j // g  == (sum_j offset_j) // g          (hops)
        sum_j nbytes_j * (offset_j // g) == (sum_j nbytes_j * offset_j) / g

    so both DP objectives reduce to one prefix-sum subtraction and one
    division — the per-relaxation cost drops from O(segment length) to O(1).
    """

    __slots__ = ("_gcd", "_off", "_woff")

    def __init__(self, steps: Sequence[Step]):
        S = len(steps)
        offsets = [st.offset for st in steps]
        self._gcd: list[list[int]] = []
        for a in range(S):
            g, row = 0, []
            for b in range(a, S):
                g = math.gcd(g, offsets[b])
                row.append(g)
            self._gcd.append(row)
        self._off = [0] * (S + 1)
        self._woff = [0.0] * (S + 1)
        for j, st in enumerate(steps):
            self._off[j + 1] = self._off[j] + st.offset
            self._woff[j + 1] = self._woff[j] + st.nbytes * st.offset

    def gcd(self, a: int, b: int) -> int:
        """Link offset (gcd of message offsets) of segment [a, b]."""
        return self._gcd[a][b - a]

    def hop_sum(self, a: int, b: int) -> int:
        """Total hop count of segment [a, b] (Lemma 3.1 objective)."""
        return (self._off[b + 1] - self._off[a]) // self.gcd(a, b)

    def tx_sum(self, a: int, b: int) -> float:
        """Transmission term sum(nbytes * hops) of segment [a, b] (Thm 3.3)."""
        return (self._woff[b + 1] - self._woff[a]) / self.gcd(a, b)

    def exact_cost(self, cm: CostModel) -> Callable[[int, int], float]:
        """Full-model segment cost: startup + hop latency + transmission."""
        alpha_s, alpha_h, beta = cm.alpha_s, cm.alpha_h, cm.beta

        def seg_cost(a: int, b: int) -> float:
            return ((b - a + 1) * alpha_s + alpha_h * self.hop_sum(a, b)
                    + beta * self.tx_sum(a, b))

        return seg_cost


# --- Legacy O(segment-length) cost closures ----------------------------------
#
# Kept as the per-R reference implementation: `_legacy_candidate_schedules`
# below reproduces the pre-planner behavior (one capped DP per (family, R),
# per-step summation order) for the parity tests and the before/after
# comparison in benchmarks/planner_bench.py.


def _hop_sum_cost(steps: Sequence[Step]) -> Callable[[int, int], float]:
    """Total hop count of a segment: sum of offset / gcd over its sub-steps.

    For radix-2 power-of-two A2A this is 2^len - 1, the paper's Lemma 3.1
    objective; for general (n, r) it is the exact per-segment hop latency.
    """

    def seg_cost(a: int, b: int) -> float:
        g = _segment_gcd(steps, a, b)
        return float(sum(steps[j].offset // g for j in range(a, b + 1)))

    return seg_cost


def _transmission_cost(steps: Sequence[Step]) -> Callable[[int, int], float]:
    """Transmission term of a segment: sum of nbytes * congestion, with
    congestion = hops = offset / gcd (uniform-offset ring traffic).

    For radix-2 power-of-two RS this is len / 2^{a+1} (the paper's Theorem
    3.3 objective up to a constant factor); exact for general (n, r).
    """

    def seg_cost(a: int, b: int) -> float:
        g = _segment_gcd(steps, a, b)
        return sum(steps[j].nbytes * (steps[j].offset // g) for j in range(a, b + 1))

    return seg_cost


def _segment_cost_exact(kind: Collective, steps: Sequence[Step], cm: CostModel) -> Callable:
    def seg_cost(a: int, b: int) -> float:
        g = _segment_gcd(steps, a, b)
        t = 0.0
        for j in range(a, b + 1):
            h = steps[j].offset // g
            t += cm.step_cost(hops=h, nbytes=steps[j].nbytes, congestion=h)
        return t

    return seg_cost


# --- Step-sequence cache (schedule synthesis calls these in tight loops) -----

_STEP_CACHE: dict[tuple[str, int, int], tuple[Step, ...]] = {}


def _steps_cached(kind: Collective, n: int, r: int) -> tuple[Step, ...]:
    key = (kind, n, r)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = tuple(steps_for(kind, n, 1.0, r))
    return _STEP_CACHE[key]


@functools.lru_cache(maxsize=4096)
def _link_offsets_cached(schedule: "Schedule") -> tuple[int, ...]:
    """Per-sub-step link offsets of a schedule, memoized per Schedule.

    Schedules are small frozen dataclasses, so the hash is cheap and the
    cache lets every evaluator (analytic, event, fabric, batch) reuse the
    segment-gcd work instead of recomputing it per run.
    """
    steps = _steps_cached(schedule.kind, schedule.n, schedule.r)
    out = [0] * len(schedule.x)
    for a, b in schedule.segments:
        g = _segment_gcd(steps, a, b)
        for j in range(a, b + 1):
            out[j] = g
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _changed_links_cached(schedule: "Schedule") -> tuple[int, ...]:
    """Changed circuits per reconfiguration boundary, memoized per Schedule."""
    steps = _steps_cached(schedule.kind, schedule.n, schedule.r)
    gs = [_segment_gcd(steps, a, b) for a, b in schedule.segments]
    return tuple(changed_links(schedule.n, gs[i - 1], gs[i])
                 for i in range(1, len(gs)))


# --- Paper-faithful schedule families, all R in one DP pass -------------------


@functools.lru_cache(maxsize=None)
def periodic_a2a_all(n: int, r: int = 2) -> tuple[Schedule, ...]:
    """Theorem 3.2 optimal All-to-All schedules for every R at once.

    Entry R of the returned tuple is the hop-sum-optimal schedule with R
    reconfigurations (balanced segments for radix 2, Lemma 3.1), extracted
    from a single all-R DP table.
    """
    steps = _steps_cached("a2a", n, r)
    tables = SegmentTables(steps)
    return tuple(
        Schedule.from_segments("a2a", n, list(lens), r)
        for _, lens in _partition_dp_all(len(steps), tables.hop_sum))


@functools.lru_cache(maxsize=None)
def rs_transmission_optimal_all(n: int, r: int = 2) -> tuple[Schedule, ...]:
    """Theorem 3.3 transmission-optimal Reduce-Scatter schedules, all R."""
    steps = _steps_cached("rs", n, r)
    tables = SegmentTables(steps)
    return tuple(
        Schedule.from_segments("rs", n, list(lens), r)
        for _, lens in _partition_dp_all(len(steps), tables.tx_sum))


def ag_transmission_optimal_all(n: int, r: int = 2) -> tuple[Schedule, ...]:
    """Section 3.5: AllGather optima = reversed Reduce-Scatter schedules."""
    return tuple(
        Schedule.from_segments("ag", n, list(reversed(rs.segment_lengths)), r)
        for rs in rs_transmission_optimal_all(n, r))


@functools.lru_cache(maxsize=512)
def full_cost_optimal_all(kind: Collective, n: int, m: float, cm: CostModel,
                          r: int = 2) -> tuple[Schedule, ...]:
    """Exact minimum-completion-time schedules for every fixed R at once.

    Beyond-paper: jointly minimizes latency + transmission (+ the fixed
    R*delta) instead of picking the better of the latency-only and
    transmission-only optima (paper Section 3.6).
    """
    steps = tuple(steps_for(kind, n, m, r))
    tables = SegmentTables(steps)
    return tuple(
        Schedule.from_segments(kind, n, list(lens), r)
        for _, lens in _partition_dp_all(len(steps), tables.exact_cost(cm)))


def periodic_all(kind: Collective, n: int, r: int = 2) -> tuple[Schedule, ...]:
    """Latency-optimal (periodic) schedules for any collective, all R.

    For A2A this is Theorem 3.2; for RS/AG the paper notes the latency-optimal
    case is identical to All-to-All (Section 3.6 / Section 5), with AG's
    segments reversed to match its descending offsets.
    """
    base = periodic_a2a_all(n, r)
    if kind == "a2a":
        return base
    out = []
    for sched in base:
        lens = sched.segment_lengths
        if kind == "ag":
            lens = tuple(reversed(lens))
        out.append(Schedule.from_segments(kind, n, list(lens), r))
    return tuple(out)


def clear_schedule_caches() -> None:
    """Drop the memoized all-R DP results (used by benchmarks for cold runs)."""
    periodic_a2a_all.cache_clear()
    rs_transmission_optimal_all.cache_clear()
    full_cost_optimal_all.cache_clear()


def _check_R(R: int, s: int) -> None:
    if not (0 <= R < s):
        raise ValueError(f"need 0 <= R={R} < S={s}")


def periodic_a2a(n: int, R: int, r: int = 2) -> Schedule:
    """Theorem 3.2: optimal All-to-All schedule, periodic for radix 2
    (balanced segments by Lemma 3.1).

    Computed by the exact DP on the hop-sum objective (2^len - 1 in the
    radix-2 case); for radix 2 the result always has segment lengths
    differing by at most one.
    """
    scheds = periodic_a2a_all(n, r)
    _check_R(R, len(scheds))
    sched = scheds[R]
    if r == 2:
        lens = sched.segment_lengths
        assert max(lens) - min(lens) <= 1, "Lemma 3.1 violated"
    return sched


def rs_transmission_optimal(n: int, R: int, r: int = 2) -> Schedule:
    """Theorem 3.3: transmission-optimal Reduce-Scatter schedule.

    The paper's ILP minimizes sum over periods [a,b] of (b - a + 1) / 2^a;
    the DP minimizes the exact per-segment transmission (identical up to a
    constant factor for radix-2 power-of-two n, exact otherwise) as an
    interval-partition DP (schedules are parameter-free).
    """
    scheds = rs_transmission_optimal_all(n, r)
    _check_R(R, len(scheds))
    return scheds[R]


def ag_transmission_optimal(n: int, R: int, r: int = 2) -> Schedule:
    """Section 3.5: AllGather optimum is the reversed Reduce-Scatter schedule."""
    scheds = ag_transmission_optimal_all(n, r)
    _check_R(R, len(scheds))
    return scheds[R]


def periodic(kind: Collective, n: int, R: int, r: int = 2) -> Schedule:
    """Latency-optimal (periodic) schedule for any of the three collectives."""
    scheds = periodic_all(kind, n, r)
    _check_R(R, len(scheds))
    return scheds[R]


def full_cost_optimal(kind: Collective, n: int, m: float, cm: CostModel,
                      R: int, r: int = 2) -> Schedule:
    """Exact minimum-completion-time schedule for fixed R under the full model."""
    scheds = full_cost_optimal_all(kind, n, float(m), cm, r)
    _check_R(R, len(scheds))
    return scheds[R]


def cstar_a2a(n: int, R: int, cm: CostModel, m: float) -> float:
    """Closed-form optimal A2A cost (Theorem 3.2; radix 2, power-of-two n),
    exact when (R+1) | s.

    C* = s*alpha_s + (R+1) * c * (n^{1/(R+1)} - 1) + R*delta,  c = alpha_h + beta*m/2.

    The derivation assumes offsets 2^k on n = 2^s nodes; anything else would
    silently return a wrong value, so non-power-of-two n is rejected (use the
    exact DPs above for general n / radix).
    """
    if not is_pow2(n) or n < 2:
        raise ValueError(
            f"cstar_a2a closed form holds only for power-of-two n >= 2 at "
            f"radix 2, got n={n}; use the DP schedules for general (n, r)")
    s = num_steps(n)
    _check_R(R, s)
    c = cm.alpha_h + cm.beta * m / 2.0
    return s * cm.alpha_s + (R + 1) * c * (n ** (1.0 / (R + 1)) - 1.0) + R * cm.delta


# --- Optimal number of reconfigurations (Section 3.6) -------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    schedule: Schedule
    predicted_time: float
    strategy: str  # which candidate family won


def candidate_schedules(
    kind: Collective, n: int, m: float, cm: CostModel,
    paper_faithful: bool = False, r: int = 2
) -> list[tuple[str, Schedule]]:
    """The per-R candidate set of paper Section 3.6, in the legacy (R-major)
    order.  Each strategy family is materialized by one all-R DP pass."""
    periodic_scheds = periodic_all(kind, n, r)
    tx_scheds: tuple[Schedule, ...] = ()
    if kind == "rs":
        tx_scheds = rs_transmission_optimal_all(n, r)
    elif kind == "ag":
        tx_scheds = ag_transmission_optimal_all(n, r)
    exact_scheds: tuple[Schedule, ...] = ()
    if not paper_faithful:
        exact_scheds = full_cost_optimal_all(kind, n, float(m), cm, r)
    cands: list[tuple[str, Schedule]] = []
    for R in range(len(periodic_scheds)):
        cands.append((f"periodic(R={R})", periodic_scheds[R]))
        if kind == "rs":
            cands.append((f"rs-early(R={R})", tx_scheds[R]))
        elif kind == "ag":
            cands.append((f"ag-late(R={R})", tx_scheds[R]))
        if not paper_faithful:
            cands.append((f"exact-dp(R={R})", exact_scheds[R]))
    return cands


def plan(
    kind: Collective, n: int, m: float, cm: CostModel,
    paper_faithful: bool = False, r: int = 2
) -> Plan:
    """Pick the schedule (incl. R, Section 3.6) minimizing modeled completion
    time.

    .. deprecated::
        Thin shim over `repro.planner.Planner`, the single planning entry
        point for all four collectives; use it directly for alternatives
        tables, constraints, fabric/objective selection, and serialization.
        Routes through `default_planner()` so repeated calls hit the shared
        LRU plan cache.  Emits a `DeprecationWarning`; removal path is
        documented in the README ("Deprecated entry points").
    """
    import warnings

    from repro_torch.planner import PlanRequest, default_planner  # local: no cycle

    warnings.warn(
        "core.schedules.plan is deprecated; construct a PlanRequest and call "
        "repro.planner.Planner.plan (see README 'Deprecated entry points' "
        "for the removal path)", DeprecationWarning, stacklevel=2)
    res = default_planner().plan(PlanRequest(
        kind=kind, n=n, m_bytes=float(m), cost_model=cm, r=r,
        paper_faithful=paper_faithful))
    assert res.schedule is not None
    return Plan(schedule=res.schedule, predicted_time=res.predicted_time,
                strategy=res.strategy)


# --- Pre-planner per-R reference implementation ------------------------------
#
# The exact legacy behavior (one capped `_partition_dp` per (family, R), no
# all-R sharing, per-step summation order).  Used by tests/test_planner.py to
# certify parity and by benchmarks/planner_bench.py as the "before" side of
# the DP-relaxation comparison.  Not part of the public API.


def _legacy_candidate_schedules(
    kind: Collective, n: int, m: float, cm: CostModel,
    paper_faithful: bool = False, r: int = 2
) -> list[tuple[str, Schedule]]:
    s = schedule_length(kind, n, r)
    a2a_steps_ = _steps_cached("a2a", n, r)
    rs_steps_ = _steps_cached("rs", n, r)
    cands: list[tuple[str, Schedule]] = []
    for R in range(0, s):
        _, lens = _partition_dp(s, R + 1, _hop_sum_cost(a2a_steps_))
        if kind == "ag":
            lens = list(reversed(lens))
        cands.append((f"periodic(R={R})", Schedule.from_segments(kind, n, lens, r)))
        if kind in ("rs", "ag"):
            _, lens = _partition_dp(s, R + 1, _transmission_cost(rs_steps_))
            if kind == "rs":
                cands.append((f"rs-early(R={R})",
                              Schedule.from_segments("rs", n, lens, r)))
            else:
                cands.append((f"ag-late(R={R})",
                              Schedule.from_segments("ag", n, list(reversed(lens)), r)))
        if not paper_faithful:
            steps_m = steps_for(kind, n, m, r)
            _, lens = _partition_dp(s, R + 1, _segment_cost_exact(kind, steps_m, cm))
            cands.append((f"exact-dp(R={R})",
                          Schedule.from_segments(kind, n, lens, r)))
    return cands


def _legacy_plan(
    kind: Collective, n: int, m: float, cm: CostModel,
    paper_faithful: bool = False, r: int = 2
) -> Plan:
    from .simulator import collective_time  # local import to avoid cycle

    best: Plan | None = None
    for name, sched in _legacy_candidate_schedules(kind, n, m, cm,
                                                   paper_faithful, r):
        t = collective_time(sched, m, cm).total
        if best is None or t < best.predicted_time:
            best = Plan(schedule=sched, predicted_time=t, strategy=name)
    assert best is not None
    return best

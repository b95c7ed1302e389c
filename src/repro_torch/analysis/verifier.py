"""Static verifier for schedules, tapes, plans, and fabric snapshots.

Checks structural invariants of every planning artifact *without running a
simulator*: each rule re-derives the claimed quantity independently — digit
classes by brute-force enumeration over destinations (not the closed forms
in `core.bruck`), segment gcds and changed-circuit sets from the raw offset
algebra (not the DP tables), boundary ledgers by direct summation — and
reports mismatches as structured `Violation` records.  Rule ids are stable
and catalogued with the paper condition each encodes in docs/invariants.md.

Trust boundaries wired through this module:

  - `repro_torch.planner.Planner` verifies every `PlanResult` before it enters the
    LRU plan cache (`verify_plan`);
  - `repro_torch.workloads.serve.PlanService` audits every `ServedPlan` before it
    is cached and served (`verify_served_plan`);
  - `repro_torch.workloads.online_planner.OnlinePlanner` audits every window DP
    solution — including warm-started suffix re-plans — before committing
    from it (`verify_window_choice`);
  - `benchmarks/verify_gate.py` statically audits every plan implied by the
    committed BENCH_*.json baselines in CI.

All verify_* functions return a list of `Violation`s (empty = clean); they
never raise on bad artifacts.  Schedule- and tape-level verification is
memoized per object, so serving-path audits of repeated schedules are
amortized-O(1).
"""
from __future__ import annotations

import functools
import math
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.batchsim import FabricSnapshot, ScheduleTape, compile_tape
from repro_torch.core.schedules import Schedule, changed_links

from .violations import Violation

if TYPE_CHECKING:  # imported for annotations only: no planner/workloads cycle
    from repro_torch.core.cost_model import CostModel
    from repro_torch.planner.api import PlanResult

KINDS = ("a2a", "rs", "ag")
TRACE_MODES = ("carryover", "cold", "static", "online")

#: relative tolerance for re-derived float ledgers (the re-derivations use
#: the same expression order as the producers, so drift means corruption)
REL_TOL = 1e-9


def _close(a: float, b: float, tol: float = REL_TOL) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def _offset_digit(offset: int, r: int) -> tuple[int, int] | None:
    """Decompose a Bruck message offset as (phase k, digit j) with
    ``offset == j * r**k`` and 1 <= j < r; None when no such form exists."""
    if offset < 1:
        return None
    k, w = 0, 1
    while w * r <= offset:
        w *= r
        k += 1
    j = offset // w
    if j * w != offset or not 1 <= j < r:
        return None
    return k, j


def _expected_structure(kind: str, n: int, r: int) -> list[tuple[int, int, int]]:
    """Expected (offset, k, j) sub-step sequence, by direct enumeration.

    A digit class (k, j) is non-empty iff j * r**k < n; A2A and RS walk
    ascending place values, AG is the exact time-reverse (paper Section 3.5).
    Independent of `core.bruck.step_counts` (which goes through the per-kind
    generators and their closed-form counts).
    """
    s, w = 0, 1
    while w < n:
        w *= r
        s += 1
    fwd = [(j * r**k, k, j)
           for k in range(s) for j in range(1, r) if j * r**k < n]
    return list(reversed(fwd)) if kind == "ag" else fwd


def _brute_count(kind: str, n: int, r: int, k: int, j: int) -> int:
    """Blocks moved by sub-step (k, j), recounted destination by destination
    (the executable definition, not the closed form):

      - a2a: blocks whose relative destination offset has k-th digit j;
      - rs / ag: blocks whose offset is a multiple of r**k with k-th digit j
        (the partial sums forwarded at phase k; AG is reversed RS).
    """
    w = r**k
    if kind == "a2a":
        return sum(1 for d in range(n) if (d // w) % r == j)
    return sum(1 for d in range(n) if d % w == 0 and (d // w) % r == j)


def _conservation(kind: str, n: int, r: int,
                  steps: Sequence[tuple[int, int, int]]) -> list[int]:
    """Destinations the tape's step sequence fails to deliver.

    Chunk conservation over the link-offset algebra: every relative offset
    d in [0, n) must be exactly covered by the digit decomposition the steps
    implement (generalized Lemma 3.2 / Section 3.1 telescoping).

      - a2a: the offsets of the steps matching d's digits must sum to d;
      - rs:  walking the steps in order must drain d's remaining offset to 0;
      - ag:  time-reverse of rs — the reversed sequence must drain d.
    """
    bad = []
    if kind == "a2a":
        for d in range(n):
            moved = sum(off for off, k, j in steps if (d // r**k) % r == j)
            if moved != d:
                bad.append(d)
        return bad
    walk = list(reversed(steps)) if kind == "ag" else list(steps)
    for d in range(n):
        rem = d
        for off, k, j in walk:
            w = r**k
            if rem % w == 0 and (rem // w) % r == j:
                rem -= off
        if rem != 0:
            bad.append(d)
    return bad


# --- tape / schedule level ----------------------------------------------------


@functools.lru_cache(maxsize=4096)
def verify_tape(tape: ScheduleTape) -> tuple[Violation, ...]:
    """All tape-level rules (memoized per tape).  See docs/invariants.md."""
    out: list[Violation] = []
    loc = f"{tape.kind} n={tape.n} r={tape.r}"

    def bad(rule: str, message: str, repro: str = "", where: str = ""):
        out.append(Violation(rule=rule, location=f"{loc}{where}",
                             message=message, repro=repro))

    if tape.kind not in KINDS or tape.n < 2 or tape.r < 2:
        bad("tape/shape", f"invalid header (kind={tape.kind!r}, n={tape.n}, "
            f"r={tape.r})")
        return tuple(out)
    expected = _expected_structure(tape.kind, tape.n, tape.r)
    n, r, S = tape.n, tape.r, len(expected)
    fields = ("offsets", "counts", "g_step", "hops", "boundary",
              "changed_pay", "seg_of")
    lens = {f: len(getattr(tape, f)) for f in fields}
    if tape.S != S or any(ln != S for ln in lens.values()):
        bad("tape/shape", f"sub-step arrays must all have length S={S}, got "
            f"S={tape.S}, {lens}")
        return tuple(out)  # later rules index by step; shape must hold first

    # tape/offset-form + the derived (k, j) of every step
    digits: list[tuple[int, int] | None] = []
    for i, off in enumerate(tape.offsets):
        kj = _offset_digit(off, r)
        if kj is None or off >= n:
            bad("tape/offset-form",
                f"offset {off} is not j*r^k with 1 <= j < r and offset < n",
                where=f" step {i}")
        digits.append(kj)
    if [  # tape/structure: the (offset) sequence itself (order + multiset)
        off for off, _, _ in expected
    ] != list(tape.offsets):
        bad("tape/structure",
            f"step offsets {list(tape.offsets)} != the {tape.kind} digit "
            f"enumeration {[off for off, _, _ in expected]}")

    # tape/counts: brute-force digit-class recount per step
    for i, (cnt, kj) in enumerate(zip(tape.counts, digits, strict=True)):
        if kj is None:
            continue
        want = _brute_count(tape.kind, n, r, *kj)
        if cnt != want:
            bad("tape/counts",
                f"count {cnt} != {want} blocks in digit class (k={kj[0]}, "
                f"j={kj[1]})", where=f" step {i}")

    # tape/conserve: every destination offset exactly covered
    if all(kj is not None for kj in digits):
        steps = [(off, *kj)
                 for off, kj in zip(tape.offsets, digits, strict=True)]
        missed = _conservation(tape.kind, n, r, steps)
        if missed:
            bad("tape/conserve",
                f"destinations {missed[:8]}{'...' if len(missed) > 8 else ''} "
                f"are not exactly covered by the step sequence",
                repro=f"offsets={list(tape.offsets)}")

    # tape/seg: boundary bits <-> segment map consistency
    if tape.boundary[0] not in (0, False):
        bad("tape/seg", "x_0 must be 0: the initial topology is "
            "pre-established before the collective starts")
    seg = [0] * S
    for k in range(1, S):
        seg[k] = seg[k - 1] + (1 if tape.boundary[k] else 0)
    if list(tape.seg_of) != seg:
        bad("tape/seg", f"seg_of {list(tape.seg_of)} != segment map "
            f"{seg} derived from the boundary bits")
    n_seg = seg[-1] + 1
    segments = [(a, b) for a, b in
                zip([k for k in range(S) if seg[k] != seg[k - 1] or k == 0],
                    [k for k in range(S)
                     if k == S - 1 or seg[k + 1] != seg[k]], strict=True)]

    # tape/gcd: per-segment link offset is the gcd of its message offsets
    seg_g = [0] * n_seg
    for si, (a, b) in enumerate(segments):
        g = 0
        for k in range(a, b + 1):
            g = math.gcd(g, tape.offsets[k])
        seg_g[si] = g
        for k in range(a, b + 1):
            if tape.g_step[k] != g:
                bad("tape/gcd",
                    f"link offset {tape.g_step[k]} != gcd {g} of segment "
                    f"{si} offsets {list(tape.offsets[a:b + 1])}",
                    where=f" step {k}")
    if len(tape.seg_g) != n_seg or list(tape.seg_g) != seg_g:
        bad("tape/seg", f"seg_g {list(tape.seg_g)} != per-segment gcds "
            f"{seg_g}")

    # tape/subring: the circuit set u -> u + g the tape claims per step must
    # be a permutation with 1 <= g < n (port-conflict freedom: every ingress
    # port receives exactly one circuit; g = 0 would self-loop, g >= n
    # aliases).  Checked on the *claimed* offsets — the re-derived gcds are
    # in range by construction.
    for k in range(S):
        g = tape.g_step[k]
        if not 1 <= g < n:
            bad("tape/subring",
                f"claimed link offset {g} is outside [1, n): the uniform "
                f"circuit set u -> u+{g} is not a conflict-free subring "
                f"permutation", where=f" step {k}")

    # tape/reach (generalized Lemma 3.2): a step's destination is reachable
    # inside its segment's subring iff the message offset is divisible by
    # the link offset; tape/hops pins the claimed hop counts to offset / g
    for k in range(S):
        g, off = tape.g_step[k], tape.offsets[k]
        if g >= 1 and off % g != 0:
            bad("tape/reach",
                f"offset {off} is not divisible by link offset {g}: the "
                f"destination is unreachable in the subring", where=f" step {k}")
        elif g >= 1 and tape.hops[k] != off // g:
            bad("tape/hops", f"hops {tape.hops[k]} != offset/g = {off // g}",
                where=f" step {k}")
    want_seg_hops = [sum(tape.hops[a:b + 1]) for a, b in segments]
    if len(tape.seg_hops) != n_seg or list(tape.seg_hops) != want_seg_hops:
        bad("tape/seg", f"seg_hops {list(tape.seg_hops)} != per-segment hop "
            f"sums {want_seg_hops}")

    # tape/changed: the sparse-boundary accounting.  changed_pay marks the
    # boundaries that physically rewire circuits; changed_links carries the
    # per-reconfiguration changed-circuit count (uniform subrings: 0 or n)
    for k in range(S):
        want = bool(tape.boundary[k]) and k > 0 and \
            tape.g_step[k] != tape.g_step[k - 1]
        if bool(tape.changed_pay[k]) != want:
            bad("tape/changed",
                f"changed_pay {bool(tape.changed_pay[k])} != {want} "
                f"(boundary={bool(tape.boundary[k])}, g {tape.g_step[k - 1] if k else '-'}"
                f"->{tape.g_step[k]})", where=f" step {k}")
    want_changed = tuple(
        0 if seg_g[i - 1] == seg_g[i] else n for i in range(1, n_seg))
    if tuple(tape.changed_links) != want_changed:
        bad("tape/changed",
            f"changed_links {tuple(tape.changed_links)} != re-derived "
            f"per-boundary circuit diffs {want_changed}")
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def verify_schedule(schedule: Schedule) -> tuple[Violation, ...]:
    """Schedule-level rules + every tape rule on its compiled tape."""
    out: list[Violation] = []
    loc = f"{schedule.kind} n={schedule.n} r={schedule.r}"
    x = schedule.x
    ok_format = True
    if any(v not in (0, 1) for v in x) or (x and x[0] != 0):
        out.append(Violation(
            rule="sch/x-format", location=loc,
            message=f"x must be 0/1 with x_0 = 0, got {list(x)}",
            repro=f"x={list(x)}"))
        ok_format = False
    try:
        expected_len = len(_expected_structure(schedule.kind, schedule.n,
                                               schedule.r))
    except Exception:
        expected_len = -1
    if len(x) != expected_len:
        out.append(Violation(
            rule="sch/x-format", location=loc,
            message=f"schedule length {len(x)} != S={expected_len}"))
        ok_format = False
    if ok_format:
        out.extend(verify_tape(compile_tape(schedule)))
    return tuple(out)


def _paid_reconfigs(schedule: Schedule) -> int:
    """Paid intra-collective reconfigurations, re-derived from raw segment
    gcds (a boundary pays iff the adjacent segments' gcds differ)."""
    gs = [g for g, _ in _segment_offsets(schedule)]
    return sum(1 for a, b in zip(gs, gs[1:], strict=False) if a != b)


def _segment_offsets(schedule: Schedule) -> list[tuple[int, int]]:
    """(gcd, first_step) of every segment, from the raw offset algebra."""
    tape = compile_tape(schedule)
    out, start = [], 0
    for k in range(1, tape.S + 1):
        if k == tape.S or tape.boundary[k]:
            g = 0
            for i in range(start, k):
                g = math.gcd(g, tape.offsets[i])
            out.append((g, start))
            start = k
    return out


def _first_last_g(schedule: Schedule) -> tuple[int, int]:
    segs = _segment_offsets(schedule)
    return segs[0][0], segs[-1][0]


# --- plan level ---------------------------------------------------------------


def _check_schedule_header(out: list[Violation], rule: str, loc: str,
                           sched: Schedule, kind: str, n: int, r: int) -> None:
    if sched.kind != kind or sched.n != n or sched.r != r:
        out.append(Violation(
            rule=rule, location=loc,
            message=f"schedule ({sched.kind}, n={sched.n}, r={sched.r}) does "
                    f"not match the request ({kind}, n={n}, r={r})"))


def verify_plan(res: "PlanResult") -> list[Violation]:
    """Every plan-level rule on one `PlanResult` (see docs/invariants.md)."""
    out: list[Violation] = []
    req = res.request
    loc = f"plan {req.kind} n={req.n} r={req.r} fabric={req.fabric}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    # plan/kind: winner schedules present and consistent with the request
    schedules: list[Schedule] = []
    if req.kind == "ar":
        if res.schedule is not None:
            bad("plan/kind", "composite 'ar' results carry (rs_schedule, "
                "ag_schedule), not a single schedule")
        if res.impl == "bruck":
            if res.rs_schedule is None or res.ag_schedule is None:
                bad("plan/kind", "bruck 'ar' winner must carry both phase "
                    "schedules")
            else:
                _check_schedule_header(out, "plan/kind", loc,
                                       res.rs_schedule, "rs", req.n, req.r)
                _check_schedule_header(out, "plan/kind", loc,
                                       res.ag_schedule, "ag", req.n, req.r)
                schedules = [res.rs_schedule, res.ag_schedule]
    else:
        if res.rs_schedule is not None or res.ag_schedule is not None:
            bad("plan/kind", f"single-collective {req.kind!r} results must "
                f"not carry ar phase schedules")
        if res.impl == "bruck":
            if res.schedule is None:
                bad("plan/kind", "bruck winner must carry a schedule")
            else:
                _check_schedule_header(out, "plan/kind", loc, res.schedule,
                                       req.kind, req.n, req.r)
                schedules = [res.schedule]
    for sched in schedules:
        out.extend(verify_schedule(sched))

    # plan/budget: reconfiguration caps hold; static fabrics never rewire
    cap = req.effective_max_R()
    R_total = sum(s.R for s in schedules)
    if schedules and cap is not None and R_total > cap:
        bad("plan/budget", f"winner spends R={R_total} > effective cap {cap} "
            f"(max_R={req.max_R}, delta_budget={req.delta_budget})")
    if schedules and req.fabric == "static" and R_total > 0:
        bad("plan/budget", f"static fabric has no OCS to rewire "
            f"mid-collective, winner has R={R_total}")

    # plan/entry: predicted time re-derived as breakdown total + the sparse
    # entry-boundary cost of the inherited fabric state (analytic fabrics
    # only: ocs-sim predictions are simulated completions, not breakdowns)
    if req.fabric != "ocs-sim":
        entry = 0.0
        entry_sched = schedules[0] if schedules else None
        if req.init_g is not None and entry_sched is not None:
            g_first, _ = _first_last_g(entry_sched)
            entry = req.cost_model.delta_sparse(
                changed_links(req.n, req.init_g, g_first), req.overlap)
        want = res.breakdown.total + entry
        if not _close(res.predicted_time, want):
            bad("plan/entry",
                f"predicted_time {res.predicted_time!r} != breakdown total "
                f"+ entry boundary = {want!r}",
                repro=f"total={res.breakdown.total!r} entry={entry!r} "
                      f"init_g={req.init_g}")

    # plan/rank: alternatives sorted best-first and the winner is the head
    alts = res.alternatives
    if not alts:
        bad("plan/rank", "a plan must rank at least its winner")
    else:
        if any(a.score > b.score
               for a, b in zip(alts, alts[1:], strict=False)):
            bad("plan/rank", "alternatives are not sorted by ascending score",
                repro=f"scores={[a.score for a in alts]}")
        if alts[0].strategy != res.strategy or alts[0].impl != res.impl:
            bad("plan/rank",
                f"winner ({res.strategy!r}, {res.impl!r}) != best-ranked "
                f"alternative ({alts[0].strategy!r}, {alts[0].impl!r})")
        if not _close(alts[0].predicted_time, res.predicted_time):
            bad("plan/rank",
                f"winner predicted_time {res.predicted_time!r} != "
                f"best-ranked row's {alts[0].predicted_time!r}")

    # plan/dedup + plan/alt: each schedule is evaluated once; row R == sum(x)
    seen_x = set()
    for i, alt in enumerate(alts):
        if alt.x is None:
            continue
        if alt.x in seen_x:
            bad("plan/dedup", f"alternative {i} duplicates schedule bits "
                f"{list(alt.x)} (each schedule must be evaluated once)")
        seen_x.add(alt.x)
        if alt.R is not None and alt.R != sum(alt.x):
            bad("plan/alt", f"alternative {i} claims R={alt.R} but its bits "
                f"sum to {sum(alt.x)}")
        if cap is not None and sum(alt.x) > cap:
            bad("plan/budget", f"alternative {i} ({alt.strategy!r}) spends "
                f"R={sum(alt.x)} > effective cap {cap}")
    return out


# --- trace / serving level ----------------------------------------------------


def _check_phases(out: list[Violation], loc: str, n: int, r: int,
                  phases, expected: Sequence[tuple[str, float, str]] | None
                  ) -> None:
    """Shared phase checks for trace plans, served plans, window choices."""
    if expected is not None and len(phases) != len(expected):
        out.append(Violation(
            rule="trace/phase", location=loc,
            message=f"{len(phases)} planned phases != {len(expected)} "
                    f"flattened trace phases"))
        expected = None
    for i, p in enumerate(phases):
        where = f"{loc} phase {i} ({p.tag or p.kind})"
        if expected is not None:
            kind, m, tag = expected[i]
            if (p.kind, p.tag) != (kind, tag) or p.m_bytes != m:
                out.append(Violation(
                    rule="trace/phase", location=where,
                    message=f"planned ({p.kind!r}, m={p.m_bytes}, "
                            f"{p.tag!r}) != trace event ({kind!r}, m={m}, "
                            f"{tag!r})"))
        _check_schedule_header(out, "trace/phase", where, p.schedule,
                               p.kind, n, r)
        if p.schedule.kind == p.kind and p.schedule.n == n \
                and p.schedule.r == r:
            out.extend(verify_schedule(p.schedule))
            paid = _paid_reconfigs(p.schedule)
            if p.paid_reconfigs != paid:
                out.append(Violation(
                    rule="trace/paid", location=where,
                    message=f"paid_reconfigs {p.paid_reconfigs} != {paid} "
                            f"boundaries whose segment gcds differ"))
        if p.time < 0:
            out.append(Violation(
                rule="trace/phase", location=where,
                message=f"negative phase time {p.time}"))


def verify_trace_plan(tp, cm: "CostModel | None" = None) -> list[Violation]:
    """Every trace-level rule on one `TracePlan`.

    ``cm`` re-derives the boundary-cost and delta-budget ledgers (the plan
    records the budget but not the cost model); without it only the
    cost-model-independent rules run.
    """
    out: list[Violation] = []
    n, r = tp.trace.n, tp.trace.r
    loc = f"trace {tp.trace.name!r} n={n} mode={tp.mode}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    if tp.mode not in TRACE_MODES:
        bad("trace/phase", f"unknown mode {tp.mode!r}")
    _check_phases(out, loc, n, r, tp.phases, tp.trace.phases())

    # trace/boundary: changed-circuit sets re-derived from raw segment gcds;
    # cold mode re-establishes every boundary with a full-fabric swap
    P = len(tp.phases)
    if len(tp.boundary_changed) != max(0, P - 1) \
            or len(tp.boundary_cost) != max(0, P - 1):
        bad("trace/boundary",
            f"{len(tp.boundary_changed)} boundary entries for {P} phases")
    else:
        for i, (prev, nxt) in enumerate(zip(tp.phases, tp.phases[1:],
                                            strict=False)):
            if tp.mode == "cold":
                want = n
            else:
                want = changed_links(n, _first_last_g(prev.schedule)[1],
                                     _first_last_g(nxt.schedule)[0])
            if tp.boundary_changed[i] != want:
                bad("trace/boundary",
                    f"boundary {i} claims {tp.boundary_changed[i]} changed "
                    f"circuits, re-derived {want}",
                    repro=f"prev g_last={_first_last_g(prev.schedule)[1]} "
                          f"next g_first={_first_last_g(nxt.schedule)[0]}")
            if cm is not None:
                want_cost = cm.delta_sparse(tp.boundary_changed[i],
                                            tp.overlap)
                if not _close(tp.boundary_cost[i], want_cost):
                    bad("trace/boundary",
                        f"boundary {i} cost {tp.boundary_cost[i]!r} != "
                        f"delta_sparse({tp.boundary_changed[i]}) = "
                        f"{want_cost!r}")
            elif tp.boundary_changed[i] == 0 and tp.boundary_cost[i] != 0.0:
                bad("trace/boundary",
                    f"boundary {i} rewires nothing but charges "
                    f"{tp.boundary_cost[i]}")

    # trace/total: the ledger re-summed
    want_total = sum(p.time for p in tp.phases) + sum(tp.boundary_cost)
    if not _close(tp.total_time, want_total):
        bad("trace/total", f"total_time {tp.total_time!r} != re-summed "
            f"phases + boundaries = {want_total!r}")

    # trace/budget: the delta-budget ledger, re-derived independently of the
    # DP's cap arithmetic
    if tp.delta_budget is not None and cm is not None:
        unit = cm.delta_sparse(n, tp.overlap)
        paid = sum(_paid_reconfigs(p.schedule) for p in tp.phases)
        if unit > 0 and paid * unit > tp.delta_budget * (1 + REL_TOL) + unit * 1e-9:
            bad("trace/budget",
                f"{paid} paid reconfigurations spend {paid * unit!r} s > "
                f"delta_budget {tp.delta_budget!r} s")
    if tp.mode == "static":
        for i, p in enumerate(tp.phases):
            if p.schedule.R != 0:
                bad("trace/budget", f"static mode phase {i} reconfigures "
                    f"(R={p.schedule.R})")
    return out


def verify_served_plan(sp, cm: "CostModel", overlap: float = 0.0
                       ) -> list[Violation]:
    """Every serving-level rule on one `ServedPlan` (see docs/invariants.md)."""
    out: list[Violation] = []
    req = sp.request
    n, r = req.n, req.r
    loc = f"serve n={n} window={len(req.events)} init_g={req.init_g}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    from repro_torch.workloads.online_planner import _flatten  # typed helper only

    _check_phases(out, loc, n, r, sp.phases, _flatten(req.events))
    if not sp.phases:
        return out

    # serve/entry: entry boundary re-derived from the inherited fabric state
    g_first = _first_last_g(sp.phases[0].schedule)[0]
    want_changed = (0 if req.init_g is None
                    else changed_links(n, req.init_g, g_first))
    if sp.entry_changed != want_changed:
        bad("serve/entry", f"entry_changed {sp.entry_changed} != re-derived "
            f"{want_changed} (init_g={req.init_g} -> g_first={g_first})")
    want_cost = cm.delta_sparse(want_changed, overlap)
    if not _close(sp.entry_cost, want_cost):
        bad("serve/entry", f"entry_cost {sp.entry_cost!r} != "
            f"delta_sparse({want_changed}) = {want_cost!r}")

    # serve/boundary + serve/total: intra-window ledger re-derived
    for i, (prev, nxt) in enumerate(zip(sp.phases, sp.phases[1:],
                                        strict=False)):
        want = changed_links(n, _first_last_g(prev.schedule)[1],
                             _first_last_g(nxt.schedule)[0])
        if i >= len(sp.boundary_changed):
            bad("serve/boundary", f"missing boundary entry {i}")
            continue
        if sp.boundary_changed[i] != want:
            bad("serve/boundary", f"boundary {i} claims "
                f"{sp.boundary_changed[i]} changed circuits, re-derived {want}")
        if not _close(sp.boundary_cost[i], cm.delta_sparse(want, overlap)):
            bad("serve/boundary", f"boundary {i} cost {sp.boundary_cost[i]!r} "
                f"!= delta_sparse({want}) = {cm.delta_sparse(want, overlap)!r}")
    want_total = (sp.entry_cost + sum(p.time for p in sp.phases)
                  + sum(sp.boundary_cost))
    if not _close(sp.total_time, want_total):
        bad("serve/total", f"total_time {sp.total_time!r} != entry + phases "
            f"+ boundaries = {want_total!r}")

    # serve/final: the fabric state handed to the job's next request
    want_final = _first_last_g(sp.phases[-1].schedule)[1]
    if sp.final_g != want_final:
        bad("serve/final", f"final_g {sp.final_g} != the last phase's final "
            f"link offset {want_final}")
    return out


def verify_shared_plan(sp) -> list[Violation]:
    """Every multi-tenant rule on one `workloads.tenancy.SharedPlan`.

    The request embedded in the plan carries the cost model, so the whole
    ledger re-derives from the artifact alone:

      tenant/ports     : port partitions are in-range, correctly sized, and
                         pairwise disjoint (and within each tenant's
                         declared port share).
      tenant/route     : a partitioned tenant's schedules are sized to its
                         own sub-fabric — no circuit can reach another
                         tenant's ports.
      tenant/order     : the time-sliced interleaving preserves each
                         tenant's own event order and covers its trace
                         exactly; completions re-derived from prefix sums.
      tenant/budget    : per-tenant (and global) intra-collective
                         reconfiguration stall re-summed against the caps.
      tenant/isolation : measured isolation ratio consistent with the
                         completion ledger and within the structural bound;
                         shared completion never above the serialized
                         baseline (both metrics).
    """
    out: list[Violation] = []
    req = sp.request
    cm, n, overlap = req.cost_model, req.n, req.overlap
    loc = f"shared {str(req.sharing)} K={len(req.tenants)} n={n}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    specs = {t.name: t for t in req.tenants}
    plans = {t.name: t for t in sp.tenants}
    if set(specs) != set(plans):
        bad("tenant/order", f"tenant plans {sorted(plans)} != requested "
            f"tenants {sorted(specs)}")
        return out
    budgets = req.resolved_budgets()

    if str(req.sharing) == "port-partition":
        taken: list[tuple[int, int, str]] = []
        for t in sp.tenants:
            spec = specs[t.name]
            where = f"{loc} tenant {t.name!r}"
            if t.ports is None or t.plan is None:
                bad("tenant/ports", f"tenant {t.name!r} has no port range "
                    f"or plan under port partitioning")
                continue
            lo, hi = t.ports
            if not (0 <= lo < hi <= n):
                bad("tenant/ports", f"tenant {t.name!r} range [{lo}, {hi}) "
                    f"is outside the fabric's [0, {n})")
            if hi - lo != spec.trace.n:
                bad("tenant/ports", f"tenant {t.name!r} owns {hi - lo} "
                    f"ports but its world is {spec.trace.n}")
            if spec.port_share is not None \
                    and hi - lo > spec.port_share * n + 1e-12:
                bad("tenant/ports", f"tenant {t.name!r} owns {hi - lo} "
                    f"ports > its share {spec.port_share} of n={n}")
            for lo2, hi2, other in taken:
                if lo < hi2 and lo2 < hi:
                    bad("tenant/ports", f"tenant {t.name!r} range "
                        f"[{lo}, {hi}) overlaps {other!r} [{lo2}, {hi2})")
            taken.append((lo, hi, t.name))
            # tenant/route: every schedule must be sized to the tenant's own
            # sub-fabric — a wider schedule would route across the partition
            for i, p in enumerate(t.plan.phases):
                if p.schedule.n != hi - lo:
                    bad("tenant/route",
                        f"tenant {t.name!r} phase {i} schedule spans "
                        f"n={p.schedule.n} != its {hi - lo}-port partition")
            out.extend(verify_trace_plan(t.plan, cm))
            if not _close(t.completion_s, t.plan.total_time):
                bad("tenant/order", f"tenant {t.name!r} completion "
                    f"{t.completion_s!r} != its plan's total "
                    f"{t.plan.total_time!r}  [{where}]")
    else:
        # tenant/order: per-tenant phase subsequences re-matched against
        # the traces, completions re-derived from the prefix-sum ledger
        seen = {name: 0 for name in specs}
        prefix, last_done = 0.0, {name: 0.0 for name in specs}
        g = None
        for i, ph in enumerate(sp.phases):
            if ph.tenant not in specs:
                bad("tenant/order", f"phase {i} owned by unknown tenant "
                    f"{ph.tenant!r}")
                continue
            expected = specs[ph.tenant].trace.phases()
            j = seen[ph.tenant]
            if j >= len(expected):
                bad("tenant/order", f"phase {i} is tenant {ph.tenant!r}'s "
                    f"{j + 1}th phase; its trace has only {len(expected)}")
            else:
                kind, m, tag = expected[j]
                if (ph.plan.kind, ph.plan.m_bytes, ph.plan.tag) \
                        != (kind, m, tag):
                    bad("tenant/order", f"phase {i} planned "
                        f"({ph.plan.kind!r}, m={ph.plan.m_bytes}, "
                        f"{ph.plan.tag!r}) != tenant {ph.tenant!r}'s next "
                        f"event ({kind!r}, m={m}, {tag!r})")
            seen[ph.tenant] = j + 1
            want_changed = (0 if g is None else
                            changed_links(n, g,
                                          _first_last_g(ph.plan.schedule)[0]))
            if ph.boundary_changed != want_changed:
                bad("tenant/order", f"phase {i} hand-off claims "
                    f"{ph.boundary_changed} changed circuits, re-derived "
                    f"{want_changed}")
            want_cost = (cm.delta_sparse(want_changed, overlap)
                         if g is not None else 0.0)
            if not _close(ph.boundary_cost, want_cost):
                bad("tenant/order", f"phase {i} hand-off cost "
                    f"{ph.boundary_cost!r} != delta_sparse"
                    f"({want_changed}) = {want_cost!r}")
            g = _first_last_g(ph.plan.schedule)[1]
            prefix += ph.boundary_cost + ph.plan.time
            last_done[ph.tenant] = prefix
        for name, cnt in seen.items():
            want = len(specs[name].trace.phases())
            if cnt != want:
                bad("tenant/order", f"tenant {name!r} got {cnt} phases, "
                    f"its trace flattens to {want}")
        for t in sp.tenants:
            if not _close(t.completion_s, last_done[t.name]):
                bad("tenant/order", f"tenant {t.name!r} completion "
                    f"{t.completion_s!r} != re-derived prefix sum "
                    f"{last_done[t.name]!r}")
        if not _close(sp.makespan_s, prefix):
            bad("tenant/order", f"makespan {sp.makespan_s!r} != re-summed "
                f"phases + hand-offs = {prefix!r}")

    # tenant/budget: the stall ledgers re-summed against per-tenant caps and
    # the global cap (same arithmetic slack as trace/budget)
    unit = cm.delta_sparse(n, overlap)
    total_paid = 0
    for t in sp.tenants:
        if str(req.sharing) == "port-partition" and t.plan is not None:
            paid = sum(_paid_reconfigs(p.schedule) for p in t.plan.phases)
            t_unit = cm.delta_sparse(specs[t.name].trace.n, overlap)
        else:
            paid = sum(_paid_reconfigs(ph.plan.schedule)
                       for ph in sp.phases if ph.tenant == t.name)
            t_unit = unit
        total_paid += paid
        if t.paid_reconfigs != paid:
            bad("tenant/budget", f"tenant {t.name!r} claims "
                f"{t.paid_reconfigs} paid reconfigurations, re-derived "
                f"{paid}")
        budget = budgets.get(t.name)
        if budget is not None and t_unit > 0 \
                and paid * t_unit > budget * (1 + REL_TOL) + t_unit * 1e-9:
            bad("tenant/budget", f"tenant {t.name!r} spends "
                f"{paid * t_unit!r} s of intra-collective stall > its "
                f"budget {budget!r} s")
    if req.delta_budget is not None and unit > 0 \
            and total_paid * unit > req.delta_budget * (1 + REL_TOL) \
            + unit * 1e-9:
        bad("tenant/budget", f"fleet spends {total_paid * unit!r} s > the "
            f"global budget {req.delta_budget!r} s")

    # tenant/isolation: the measured ratios and the structural bound
    weighted = sum(t.weight * t.completion_s for t in sp.tenants)
    if not _close(sp.weighted_completion_s, weighted):
        bad("tenant/isolation", f"weighted completion "
            f"{sp.weighted_completion_s!r} != re-summed {weighted!r}")
    if sp.makespan_s > sp.serialized_s * (1 + REL_TOL):
        bad("tenant/isolation", f"shared makespan {sp.makespan_s!r} > "
            f"serialized baseline {sp.serialized_s!r}")
    if sp.weighted_completion_s > sp.serialized_weighted_s * (1 + REL_TOL):
        bad("tenant/isolation", f"shared weighted completion "
            f"{sp.weighted_completion_s!r} > serialized "
            f"{sp.serialized_weighted_s!r}")
    for t in sp.tenants:
        if t.alone_s > 0 and not _close(t.isolation,
                                        t.completion_s / t.alone_s):
            bad("tenant/isolation", f"tenant {t.name!r} isolation "
                f"{t.isolation!r} != completion/alone = "
                f"{t.completion_s / t.alone_s!r}")
        if t.isolation > t.isolation_bound * (1 + REL_TOL):
            bad("tenant/isolation", f"tenant {t.name!r} isolation "
                f"{t.isolation!r} exceeds its bound {t.isolation_bound!r}")
    return out


def verify_window_choice(n: int, chosen, *, init_spent: int = 0,
                         cap: int | None = None,
                         label: str = "window") -> list[Violation]:
    """Audit one window DP solution (a `PhaseCandidate` list) before any of
    it is committed — the online planner's warm-started suffix re-plans go
    through this, so a corrupt candidate table can never move the committed
    fabric-state ledger."""
    out: list[Violation] = []
    spent = init_spent
    for i, cand in enumerate(chosen):
        loc = f"{label} phase {i} ({cand.strategy})"
        out.extend(verify_schedule(cand.schedule))
        g_first, g_last = _first_last_g(cand.schedule)
        if (cand.g_first, cand.g_last) != (g_first, g_last):
            out.append(Violation(
                rule="window/g", location=loc,
                message=f"candidate claims (g_first={cand.g_first}, "
                        f"g_last={cand.g_last}), schedule has ({g_first}, "
                        f"{g_last}): carryover boundaries would be mispriced"))
        paid = _paid_reconfigs(cand.schedule)
        if cand.paid != paid:
            out.append(Violation(
                rule="window/paid", location=loc,
                message=f"candidate claims {cand.paid} paid reconfigs, "
                        f"schedule pays {paid}"))
        if cand.time < 0:
            out.append(Violation(
                rule="window/g", location=loc,
                message=f"negative phase time {cand.time}"))
        spent += paid
    if cap is not None and spent > cap:
        out.append(Violation(
            rule="window/cap", location=label,
            message=f"window spends {spent} reconfigurations "
                    f"(init {init_spent}) > trace-wide cap {cap}"))
    return out


# --- fault timelines / degraded state / recovery ------------------------------


def verify_timeline(tl) -> list[Violation]:
    """Structural validity of a `core.faults.FaultTimeline`, re-derived
    independently of its constructor checks (a timeline deserialized or
    field-copied past `__post_init__` must still be rejected here)."""
    from repro_torch.core.faults import DELIVERY_POLICIES, FAULT_KINDS

    out: list[Violation] = []
    loc = f"faults n={tl.n}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    if tl.n < 2:
        bad("fault/spec", f"need at least 2 nodes, got n={tl.n}")
    if tl.policy not in DELIVERY_POLICIES:
        bad("fault/spec", f"delivery policy {tl.policy!r} is not one of "
            f"{DELIVERY_POLICIES}")
    if not tl.faults:
        bad("fault/spec", "a fault timeline needs at least one fault")
    for i, f in enumerate(tl.faults):
        where = f" fault {i}"
        if f.kind not in FAULT_KINDS:
            bad("fault/spec", f"kind {f.kind!r} is not one of {FAULT_KINDS}",
                repro=where)
        if not (math.isfinite(f.time) and f.time >= 0):
            bad("fault/spec", f"time {f.time} must be finite and >= 0",
                repro=where)
        if not (math.isfinite(f.repair_s) and f.repair_s >= 0):
            bad("fault/spec", f"repair_s {f.repair_s} must be finite and "
                f">= 0", repro=where)
        if f.repair_s > 0 and f.kind != "link-flap":
            bad("fault/spec", f"repair_s {f.repair_s} on a {f.kind!r} fault "
                f"(only link-flap repairs)", repro=where)
        if f.kind == "node-join":
            if f.node != tl.n:
                bad("fault/spec", f"node-join must join at index n={tl.n}, "
                    f"got node={f.node}", repro=where)
        elif not 0 <= f.node < tl.n:
            bad("fault/spec", f"node {f.node} outside [0, {tl.n})",
                repro=where)
    for i, (a, b) in enumerate(zip(tl.faults, tl.faults[1:], strict=False)):
        if b.time < a.time:
            bad("fault/order", f"fault {i + 1} at t={b.time} precedes fault "
                f"{i} at t={a.time}: timelines are time-sorted")
    return out


def verify_degraded(ds, phases=None, chunks_per_msg: int = 32
                    ) -> list[Violation]:
    """Consistency of a `core.faults.DegradedState` against its fault.

    ``phases`` (the (schedule, m) pairs the faulted run played) enables the
    chunk-conservation recount: the committed chunks are re-derived from the
    committed phases' tapes — n * C * sum(segment hops) per phase — instead
    of trusting the engine's counter.
    """
    from repro_torch.core.faults import (ABRUPT_KINDS, DELIVERY_POLICIES,
                                   world_after)

    out: list[Violation] = []
    loc = f"degraded n={ds.n} kind={ds.fault.kind}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    # fault/mask: surviving world and dead circuits re-derived from the kind
    survivors, dead = world_after(ds.n, ds.fault)
    if tuple(ds.survivors) != survivors:
        bad("fault/mask", f"survivors {tuple(ds.survivors)} != re-derived "
            f"{survivors} for a {ds.fault.kind} at node {ds.fault.node}")
    if tuple(ds.dead_ports) != dead:
        bad("fault/mask", f"dead_ports {tuple(ds.dead_ports)} != re-derived "
            f"{dead}")
    if set(ds.dead_ports) & set(ds.survivors):
        bad("fault/mask", f"dead ports {tuple(ds.dead_ports)} overlap the "
            f"surviving world: traffic would route over a dead circuit")
    if ds.new_n < 2:
        bad("fault/mask", f"surviving world has {ds.new_n} nodes; schedules "
            f"need at least 2")
    abrupt = ds.fault.kind in ABRUPT_KINDS
    if abrupt and ds.aborted_phase != ds.completed_phases:
        bad("fault/mask", f"abrupt {ds.fault.kind} must abort the phase "
            f"after the committed prefix: aborted_phase={ds.aborted_phase} "
            f"!= completed_phases={ds.completed_phases}")
    if not abrupt and ds.aborted_phase is not None:
        bad("fault/mask", f"graceful {ds.fault.kind} drains the in-flight "
            f"phase, but aborted_phase={ds.aborted_phase}")
    if ds.completed_phases < 0:
        bad("fault/mask", f"completed_phases {ds.completed_phases} < 0")
    if phases is not None and ds.completed_phases >= len(phases):
        bad("fault/mask", f"completed_phases {ds.completed_phases} leaves no "
            f"work in a {len(phases)}-phase trace: the fault never took "
            f"effect")
    if ds.completed_phases > 0 and ds.snapshot is None:
        bad("fault/mask", f"{ds.completed_phases} committed phases but no "
            f"committed-prefix snapshot")

    # resume-clock re-derivation per kind
    if ds.fault.kind == "link-down" and ds.resume_clock != ds.fault.time:
        bad("fault/mask", f"link-down resumes at the fault time "
            f"{ds.fault.time!r}, got {ds.resume_clock!r}")
    if ds.fault.kind == "link-flap" \
            and ds.resume_clock != ds.fault.time + ds.fault.repair_s:
        bad("fault/mask", f"link-flap resumes at fault time + repair = "
            f"{ds.fault.time + ds.fault.repair_s!r}, got {ds.resume_clock!r}")
    if ds.snapshot is not None:
        if not abrupt and not _close(ds.resume_clock, ds.snapshot.clock):
            bad("fault/mask", f"graceful faults resume at the drained "
                f"boundary's clock {ds.snapshot.clock!r}, got "
                f"{ds.resume_clock!r}")
        if ds.snapshot.clock > ds.resume_clock * (1 + REL_TOL) + REL_TOL:
            bad("fault/mask", f"snapshot clock {ds.snapshot.clock!r} is past "
                f"the resume clock {ds.resume_clock!r}: the committed prefix "
                f"would not have drained before the fault")
        out.extend(verify_snapshot(ds.snapshot))

    # fault/conserve: the chunk ledger
    if ds.policy not in DELIVERY_POLICIES:
        bad("fault/conserve", f"delivery policy {ds.policy!r} is not one of "
            f"{DELIVERY_POLICIES}")
    for name in ("committed_chunks", "in_flight_chunks", "lost_chunks",
                 "requeued_chunks"):
        if getattr(ds, name) < 0:
            bad("fault/conserve", f"{name} {getattr(ds, name)} < 0")
    if ds.lost_chunks + ds.requeued_chunks != ds.in_flight_chunks:
        bad("fault/conserve",
            f"lost {ds.lost_chunks} + requeued {ds.requeued_chunks} != "
            f"in-flight {ds.in_flight_chunks}: chunks leaked at the fault")
    if ds.policy == "drop" and ds.requeued_chunks:
        bad("fault/conserve", f"policy 'drop' re-queued "
            f"{ds.requeued_chunks} chunks")
    if ds.policy == "requeue" and ds.lost_chunks:
        bad("fault/conserve", f"policy 'requeue' lost {ds.lost_chunks} "
            f"chunks")
    if not abrupt and ds.in_flight_chunks:
        bad("fault/conserve", f"graceful {ds.fault.kind} drains the "
            f"in-flight phase, but {ds.in_flight_chunks} chunks were in "
            f"flight")
    if phases is not None and ds.completed_phases <= len(phases):
        C = max(1, int(chunks_per_msg))
        want = sum(ds.n * C * sum(compile_tape(s).seg_hops)
                   for s, _ in phases[:ds.completed_phases])
        if ds.committed_chunks != want:
            bad("fault/conserve",
                f"committed_chunks {ds.committed_chunks} != {want} services "
                f"recounted from the {ds.completed_phases} committed phases' "
                f"tapes (n * C * segment hops)")
    return out


def verify_recovery(ds, recovery_plan, clean_plan=None) -> list[Violation]:
    """Audit a degraded-mode recovery plan against its `DegradedState`.

    ``fault/route``: the plan must target exactly the surviving world — no
    schedule may route traffic over a dead circuit or a departed node.
    ``fault/replan``: against ``clean_plan`` (the offline carryover plan of
    the reduced trace), the recovery plan must be bit-identical — same
    schedules, same total — so the recovered result matches a clean run of
    the reduced world exactly.
    """
    out: list[Violation] = []
    loc = f"recovery n={ds.n}->{ds.new_n} kind={ds.fault.kind}"

    def bad(rule: str, message: str, repro: str = ""):
        out.append(Violation(rule=rule, location=loc, message=message,
                             repro=repro))

    if set(ds.dead_ports) & set(ds.survivors):
        bad("fault/route", f"dead ports {tuple(ds.dead_ports)} overlap the "
            f"surviving world {tuple(ds.survivors)}")
    if recovery_plan.trace.n != ds.new_n:
        bad("fault/route",
            f"recovery plan targets n={recovery_plan.trace.n}, the "
            f"surviving world has {ds.new_n} nodes: traffic would be routed "
            f"over the {'dead circuit' if ds.dead_ports else 'old world'}")
    for i, p in enumerate(recovery_plan.phases):
        if p.schedule.n != ds.new_n:
            bad("fault/route", f"phase {i} schedule is for n={p.schedule.n} "
                f"!= surviving {ds.new_n}")
    out.extend(verify_trace_plan(recovery_plan))

    if clean_plan is not None:
        if clean_plan.trace.n != ds.new_n:
            bad("fault/replan", f"clean reference plan targets "
                f"n={clean_plan.trace.n} != surviving {ds.new_n}")
        if recovery_plan.schedules() != clean_plan.schedules():
            bad("fault/replan",
                "recovery schedules differ from the offline carryover plan "
                "of the reduced trace: the recovered result cannot be "
                "bit-identical to a clean run at the reduced n")
        elif recovery_plan.total_time != clean_plan.total_time:
            bad("fault/replan",
                f"identical schedules but total {recovery_plan.total_time!r}"
                f" != clean {clean_plan.total_time!r}: the boundary ledger "
                f"diverged")
    return out


# --- fabric snapshots ---------------------------------------------------------


def verify_snapshot(snap: FabricSnapshot) -> list[Violation]:
    """Structural validity of a resumable fabric state."""
    out: list[Violation] = []
    loc = f"snapshot n={snap.n}"

    def bad(rule: str, message: str):
        out.append(Violation(rule=rule, location=loc, message=message))

    if snap.n < 2:
        bad("snap/shape", f"need at least 2 nodes, got n={snap.n}")
        return out
    for name in ("node_ready", "port_free"):
        v = getattr(snap, name)
        if len(v) != snap.n:
            bad("snap/shape", f"{name} has length {len(v)} != n={snap.n}")
        elif any(not (t >= 0.0 and math.isfinite(t)) for t in v):
            bad("snap/range", f"{name} entries must be finite and >= 0")
    if not 1 <= snap.link_offset < snap.n:
        bad("snap/range", f"link_offset {snap.link_offset} outside [1, n): "
            f"not a subring the fabric can be parked on")
    if snap.chunks_moved < 0 or snap.reconfigs_paid < 0 \
            or snap.delta_stall < 0:
        bad("snap/range", "prefix accounting must be >= 0, got "
            f"(chunks={snap.chunks_moved}, paid={snap.reconfigs_paid}, "
            f"stall={snap.delta_stall})")
    return out


def clear_verifier_caches() -> None:
    """Drop memoized per-schedule/tape verification results."""
    verify_tape.cache_clear()
    verify_schedule.cache_clear()

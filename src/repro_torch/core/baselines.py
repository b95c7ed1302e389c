"""Baseline collective algorithms/strategies from the paper's evaluation.

  S-BRUCK : static Bruck, never reconfigures (schedule x = 0).
  G-BRUCK : greedy BvN Bruck, reconfigures before every step (after step 0,
            whose offset-1 exchange is already direct on the initial ring).
  RING    : bandwidth-optimal ring algorithm (Hamiltonian ring);
            (n-1) unit-hop steps of m/n for RS/AG, 2(n-1) for AllReduce.
  DIRECT  : n-1 point-to-point exchange All-to-All on the static ring.
  HD      : static halving-doubling; identical per-step distance/data sequence
            to Bruck on static fabrics (paper Section 2), pairwise not cyclic.
  R-HD    : reconfigurable HD (prior work): ring until the first
            reconfiguration; each reconfigured matching helps only its own
            step, so every step after the first reconfiguration must also
            reconfigure => with R reconfigurations the *last* R steps are
            matched at h = c = 1 and R*delta is charged.
"""
from __future__ import annotations

from .bruck import Collective, steps_for
from .cost_model import CostModel
from .schedules import every_step_schedule, plan, static_schedule
from .simulator import StepCost, TimeBreakdown, collective_time


def s_bruck(kind: Collective, n: int, m: float, cm: CostModel, r: int = 2,
            **kw) -> TimeBreakdown:
    return collective_time(static_schedule(kind, n, r), m, cm, **kw)


def g_bruck(kind: Collective, n: int, m: float, cm: CostModel, r: int = 2,
            **kw) -> TimeBreakdown:
    return collective_time(every_step_schedule(kind, n, r), m, cm, **kw)


def _uniform_steps(count: int, nbytes: float, cm: CostModel) -> TimeBreakdown:
    t_step = cm.step_cost(hops=1, nbytes=nbytes, congestion=1.0)
    steps = tuple(StepCost(i, 1, 1.0, nbytes, False, t_step) for i in range(count))
    return TimeBreakdown(
        startup=count * cm.alpha_s,
        hop_latency=count * cm.alpha_h,
        transmission=count * nbytes * cm.beta,
        reconfig=0.0,
        steps=steps,
    )


def ring(kind: str, n: int, m: float, cm: CostModel) -> TimeBreakdown:
    """RING algorithm: neighbor-only steps, no congestion, no reconfiguration."""
    if kind in ("rs", "ag"):
        return _uniform_steps(n - 1, m / n, cm)
    if kind == "ar":
        return _uniform_steps(2 * (n - 1), m / n, cm)
    raise ValueError(f"ring not defined for {kind}")


def direct_a2a(n: int, m: float, cm: CostModel) -> TimeBreakdown:
    """n-1 point-to-point exchanges on the static ring (paper Section 2)."""
    startup = hop = tx = 0.0
    steps = []
    for j in range(1, n):
        h = j  # node u -> u + j: j hops, congestion j (uniform offset traffic)
        t = cm.step_cost(hops=h, nbytes=m / n, congestion=float(h))
        startup += cm.alpha_s
        hop += h * cm.alpha_h
        tx += (m / n) * h * cm.beta
        steps.append(StepCost(j - 1, h, float(h), m / n, False, t))
    return TimeBreakdown(startup, hop, tx, 0.0, tuple(steps))


# --- Halving-Doubling --------------------------------------------------------


def _hd_phase_steps(kind: Collective, n: int, m: float, r: int = 2) -> list:
    """HD has the same (distance, bytes) sequence per phase as Bruck (paper S2)."""
    return steps_for(kind, n, m, r)


def hd_static(kind: Collective, n: int, m: float, cm: CostModel,
              r: int = 2) -> TimeBreakdown:
    """Static HD: h = c = distance on the ring for every step."""
    startup = hop = tx = 0.0
    per = []
    for st in _hd_phase_steps(kind, n, m, r):
        h = st.offset
        t = cm.step_cost(hops=h, nbytes=st.nbytes, congestion=float(h))
        startup += cm.alpha_s
        hop += h * cm.alpha_h
        tx += st.nbytes * h * cm.beta
        per.append(StepCost(st.index, h, float(h), st.nbytes, False, t))
    return TimeBreakdown(startup, hop, tx, 0.0, tuple(per))


def hd_allreduce_static(n: int, m: float, cm: CostModel) -> TimeBreakdown:
    return hd_static("rs", n, m, cm) + hd_static("ag", n, m, cm)


def r_hd(
    kind: str, n: int, m: float, cm: CostModel, R: int, r: int = 2
) -> TimeBreakdown:
    """Reconfigurable HD with exactly R reconfigurations (suffix-matched).

    kind: 'rs', 'ag' or 'ar' (= rs phase followed by ag phase, 2s steps).
    The last R steps run on per-step matchings (h = c = 1) at delta each; all
    earlier steps run on the static ring.
    """
    if kind == "ar":
        seq = _hd_phase_steps("rs", n, m, r) + _hd_phase_steps("ag", n, m, r)
    else:
        seq = _hd_phase_steps(kind, n, m, r)
    total = len(seq)
    if not (0 <= R <= total):
        raise ValueError(f"R={R} out of range for {total} steps")
    startup = hop = tx = 0.0
    per = []
    for i, st in enumerate(seq):
        matched = i >= total - R
        h = 1 if matched else st.offset
        t = cm.step_cost(hops=h, nbytes=st.nbytes, congestion=float(h))
        if matched:
            t += cm.delta
        startup += cm.alpha_s
        hop += h * cm.alpha_h
        tx += st.nbytes * h * cm.beta
        per.append(StepCost(i, h, float(h), st.nbytes, matched, t))
    return TimeBreakdown(startup, hop, tx, R * cm.delta, tuple(per))


def r_hd_optimal(kind: str, n: int, m: float, cm: CostModel,
                 r: int = 2) -> tuple[TimeBreakdown, int]:
    """R-HD with the completion-time-optimal number of reconfigurations."""
    total = len(_hd_phase_steps("rs", n, m, r)) * (2 if kind == "ar" else 1)
    best, best_R = None, 0
    for R in range(total + 1):
        t = r_hd(kind, n, m, cm, R, r)
        if best is None or t.total < best.total:
            best, best_R = t, R
    assert best is not None
    return best, best_R


def r_hd_episodic_time(kind: str, n: int, m: float, cm: CostModel,
                       r: int = 2) -> float:
    """Beyond-paper *strengthened* R-HD adversary (returns completion time).

    The paper's R-HD reconfigures once and must then keep reconfiguring (the
    matching destroys the ring).  This variant may also pay a second delta to
    restore the ring after a shortcut episode, so any subset of steps can be
    matched.  Optimal choice is per-step: match step k iff the saving
    (alpha_h + beta*m_k)(d_k - 1) exceeds its reconfiguration charge; a step
    adjacent to another matched step shares the return-to-ring delta.
    Solved exactly by a tiny DP over (step, currently-matched) states.
    """
    if kind == "ar":
        seq = _hd_phase_steps("rs", n, m, r) + _hd_phase_steps("ag", n, m, r)
    else:
        seq = _hd_phase_steps(kind, n, m, r)
    INF = float("inf")
    # dp[state]: state 0 = on ring, 1 = on matching (must pay delta to leave
    # or to re-match for the next step's pairs)
    dp = {0: 0.0, 1: INF}
    for st in seq:
        ring_cost = cm.step_cost(hops=st.offset, nbytes=st.nbytes,
                                 congestion=float(st.offset))
        match_cost = cm.step_cost(hops=1, nbytes=st.nbytes, congestion=1.0)
        ndp = {
            # stay/return to ring (returning costs delta)
            0: min(dp[0] + ring_cost, dp[1] + cm.delta + ring_cost),
            # (re-)configure a matching for this step's pairs: delta always
            1: min(dp[0], dp[1]) + cm.delta + match_cost,
        }
        dp = ndp
    return min(dp[0], dp[1] + cm.delta)  # restore the ring at the end


# --- BRIDGE end-to-end -------------------------------------------------------


def bridge(kind: Collective, n: int, m: float, cm: CostModel,
           paper_faithful: bool = True, r: int = 2) -> TimeBreakdown:
    """BRIDGE with the optimal schedule and optimal R (paper Section 3.6)."""
    p = plan(kind, n, m, cm, paper_faithful=paper_faithful, r=r)
    return collective_time(p.schedule, m, cm)


def bridge_allreduce(n: int, m: float, cm: CostModel,
                     paper_faithful: bool = True, r: int = 2) -> TimeBreakdown:
    """BRIDGE AllReduce = optimal RS phase + optimal AG phase (+ transition)."""
    from .simulator import allreduce_time

    rs = plan("rs", n, m, cm, paper_faithful=paper_faithful, r=r).schedule
    ag = plan("ag", n, m, cm, paper_faithful=paper_faithful, r=r).schedule
    return allreduce_time(rs, ag, m, cm)


def bridge_allreduce_fixed_R(n: int, m: float, cm: CostModel, R: int,
                             r: int = 2) -> TimeBreakdown:
    """Best BRIDGE AllReduce using exactly R reconfigurations total (Fig. 1).

    Searches the split of R between the RS and AG phases; within a phase uses
    the exact fixed-R schedule (full-cost DP).
    """
    from .bruck import schedule_length
    from .schedules import full_cost_optimal
    from .simulator import allreduce_time

    s = schedule_length("rs", n, r)
    best = None
    for r_rs in range(0, min(R, s - 1) + 1):
        r_ag = R - r_rs
        if r_ag > s - 1:
            continue
        rs = full_cost_optimal("rs", n, m, cm, r_rs, r)
        ag = full_cost_optimal("ag", n, m, cm, r_ag, r)
        t = allreduce_time(rs, ag, m, cm)
        if best is None or t.total < best.total:
            best = t
    assert best is not None
    return best

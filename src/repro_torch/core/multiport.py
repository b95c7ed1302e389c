"""Multiport Bruck (paper Section 3.1, last paragraph).

With p local ports per node, p independent communication offsets run in
parallel within one step, collapsing Bruck to ceil(log_{p+1} n) steps: the
radix-(p+1) generalization.  In step k, node u sends to the p peers
u + j * (p+1)^k (j = 1..p) simultaneously; data for All-to-All is the blocks
whose destination's k-th radix-(p+1) digit equals j.

This module reuses the mixed-radix step generation in `bruck.py`: a
multiport *step* is one digit phase, executing all of the phase's sub-steps
(one per digit value) concurrently on separate port pairs.  Sub-step data
volumes are the exact digit-class sizes, so arbitrary n is supported.

Subring structure generalizes: reconfiguring at phase k forms interleaved
sub-fabrics (residues mod (p+1)^k); all later offsets are multiples of
(p+1)^k, so reachability and reuse (Conditions 1-3) carry over.

Cost model per step (single-port-per-peer serialization, the paper's
convention): each of the p transfers uses its own port pair, so a step costs
  alpha_s + max_j [ h_{k,j} * alpha_h + m_{k,j} * c_{k,j} * beta ].
"""
from __future__ import annotations

import itertools

from .bruck import a2a_steps, num_steps
from .cost_model import CostModel
from .simulator import StepCost, TimeBreakdown


def num_steps_multiport(n: int, p: int) -> int:
    if p < 1:
        raise ValueError("need p >= 1 ports")
    return num_steps(n, p + 1) if n > 1 else 0


def a2a_multiport_time(
    n: int, m: float, p: int, cm: CostModel, reconfigure_every: int = 0
) -> TimeBreakdown:
    """All-to-All with radix-(p+1) Bruck and optional periodic reconfiguration.

    reconfigure_every = r > 0 reconfigures before phases r, 2r, ... (the
    periodic-optimal structure of Theorem 3.2 applies unchanged: segment cost
    is convex in length for any radix).  r = 0 means static.
    """
    radix = p + 1
    startup = hop_lat = tx = 0.0
    steps: list[StepCost] = []
    n_reconf = 0
    link = 1  # current link offset (smallest offset of the active segment)
    by_phase = itertools.groupby(a2a_steps(n, m, radix), key=lambda st: st.phase)
    for k, phase_steps in by_phase:
        reconf = reconfigure_every and k and k % reconfigure_every == 0
        if reconf:
            link = radix ** k
            n_reconf += 1
        # per-port transfer j: offset j*radix^k, volume = its digit-class size
        worst = 0.0
        h_max = 0
        m_max = 0.0
        for st in phase_steps:
            h = max(1, st.offset // link)
            t_j = h * cm.alpha_h + st.nbytes * h * cm.beta  # c = h on rings
            if t_j > worst:
                worst, h_max, m_max = t_j, h, st.nbytes
        startup += cm.alpha_s
        hop_lat += h_max * cm.alpha_h
        tx += worst - h_max * cm.alpha_h
        steps.append(StepCost(k, h_max, float(h_max), m_max, bool(reconf),
                              cm.alpha_s + worst))
    return TimeBreakdown(startup, hop_lat, tx, n_reconf * cm.delta,
                         tuple(steps))

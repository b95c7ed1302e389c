"""Static fast-path certification for the batch fabric engine.

`batchsim._play` guarantees exactness by serving every port's traffic in the
*canonical* order and then checking, from the computed timeline, two runtime
sufficient conditions for the event-driven heap to coincide with it:

  guard 1 (hop-1 / injection order): no relayed hop-1 chunk may arrive at a
      port at or before the port's own step injection;
  guard 2 (cross-step overtaking): within a segment, no step's first arrival
      may precede (or tie with) any earlier step's arrival at the same port.

Those checks cost the engine its ``first_arr`` / ``last_arr`` /
``seg_max_arr`` bookkeeping on every step of every lane.  This module decides
the same question *statically* — from the tape and the cost-model regime
alone, before anything is played — so certified lanes skip the runtime
guards (and therefore the scalar-oracle fallback test) entirely.

Soundness.  Call a lane *uniform* when it has no per-node skew:
``link_speed is None``, ``payload_scale is None``, and (for trace lanes) no
initial snapshot.  On a uniform lane every port sees bit-identical float
values at every stage of the playback — the fabric is rotationally
symmetric, all ports share one ``inj`` / ``F`` / ``tau`` value per step, and
the gather by a constant link offset permutes equal values.  Under that
symmetry:

  - guard 1 is unreachable or strictly satisfied whenever each step has
    ``hops <= 1`` (no relayed stream exists) or its hop-1 arrival is
    strictly later than the injection:
    ``nxt0 = max(F, inj) + tau + alpha_h >= inj + tau + alpha_h > inj``
    as soon as ``tau > 0`` (positive payload: ``m * beta > 0``) or
    ``alpha_h > 0``.
  - guard 2 is strictly satisfied whenever ``alpha_s > 0``: step k's first
    arrival is its injection ``recv_{k-1} + alpha_s`` (relayed arrivals only
    add non-negative ``tau``/``alpha_h`` on top), every earlier arrival
    tracked by ``seg_max_arr`` is bounded by that step's delivery time, and
    deliveries are non-decreasing in canonical order — so the +alpha_s gap
    keeps the comparison strict.

Hence the certificate:

    uniform  AND  alpha_s > 0  AND
    (alpha_h > 0  OR  m * beta > 0  OR  max(hops) <= 1)   per payload phase

It is deliberately *sufficient, not necessary*: skewed lanes and
zero-latency regimes simply fall back to the runtime guards, which remain in
place for uncertified lanes.  The differential grid in
``tests/test_certifier.py`` pins certified lanes bit-exact against the
scalar oracle across the batchsim fuzz grid, and asserts no lane the runtime
guards would have failed is ever certified.

The certificate also gates the JAX backend (`repro_torch.core.batchsim_jax`): the
XLA kernel carries neither the runtime guards nor the per-port skew arrays,
so *only* certified lanes may run on it — certification implies uniformity
(no ``link_speed`` / ``payload_scale``) and proves the guards could not have
tripped, which is exactly what the guard-free kernel needs.
`partition_backends` is the routing decision `batch_run(backend="jax")`
executes: certified lanes to XLA, everything else to the guarded NumPy
playback with its scalar-oracle fallback.

The per-(schedule, regime) decision is memoized, so serving paths that
score the same candidate schedules under one cost model pay the tape scan
once.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from repro_torch.core.batchsim import BatchLane, TraceLane, compile_tape
from repro_torch.core.cost_model import CostModel
from repro_torch.core.schedules import Schedule


@functools.lru_cache(maxsize=8192)
def _certify_schedule(schedule: Schedule, alpha_s_pos: bool,
                      alpha_h_pos: bool, payload_pos: bool) -> bool:
    """Memoized per-(schedule, regime) certificate for one uniform payload
    phase.  The regime is collapsed to the three booleans the soundness
    argument actually depends on, so e.g. every positive-payload request
    under one cost model shares a single cache entry per schedule."""
    if not alpha_s_pos:                       # guard 2 needs the +alpha_s gap
        return False
    if alpha_h_pos or payload_pos:            # guard 1 strictly satisfied
        return True
    tape = compile_tape(schedule)
    return max(tape.hops, default=0) <= 1     # guard 1 unreachable


def certify_lane(lane: BatchLane, cm: CostModel) -> bool:
    """True iff ``lane`` provably cannot trip either runtime guard of
    `batchsim._play` (see module docstring), so its vectorized playback is
    exact without the guards or the scalar-oracle fallback."""
    if lane.link_speed is not None or lane.payload_scale is not None:
        return False                          # skew breaks port symmetry
    return _certify_schedule(
        lane.schedule, cm.alpha_s > 0.0, cm.alpha_h > 0.0,
        lane.m_bytes * cm.beta > 0.0)


def certify_trace_lane(lane: TraceLane, cm: CostModel) -> bool:
    """Trace-lane certificate: uniform, not resumed from a snapshot (the
    restored per-port state breaks rotational symmetry), and every payload
    phase individually certified."""
    if lane.link_speed is not None or lane.payload_scale is not None \
            or lane.initial is not None:
        return False
    a_s, a_h = cm.alpha_s > 0.0, cm.alpha_h > 0.0
    return all(
        _certify_schedule(sched, a_s, a_h, m * cm.beta > 0.0)
        for sched, m in lane.phases)


def certify_batch(lanes: Sequence[BatchLane], cm: CostModel) -> np.ndarray:
    """Per-lane certificates as a [B] bool array (batch_run's mask)."""
    return np.array([certify_lane(lane, cm) for lane in lanes], dtype=bool)


def certify_trace_batch(lanes: Sequence[TraceLane],
                        cm: CostModel) -> np.ndarray:
    """Per-lane certificates as a [B] bool array (batch_run_trace's mask)."""
    return np.array([certify_trace_lane(lane, cm) for lane in lanes],
                    dtype=bool)


def partition_backends(lanes: Sequence[BatchLane],
                       cm: CostModel) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a batch into its JAX-eligible and NumPy-only lanes.

    Returns ``(jax_idx, numpy_idx, certified)``: the certificate mask plus
    the index arrays `batch_run(backend="jax")` routes with.  Eligibility
    *is* certification — there is no separate JAX criterion, because the
    certificate is precisely the proof that the guard-free, skew-free XLA
    kernel computes the same timeline as the guarded NumPy playback.
    """
    certified = certify_batch(lanes, cm)
    return np.flatnonzero(certified), np.flatnonzero(~certified), certified


def clear_certifier_cache() -> None:
    """Drop memoized certificates (benchmarks use this for cold timings)."""
    _certify_schedule.cache_clear()

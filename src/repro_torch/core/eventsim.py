"""Event-driven message-level simulator (the paper's ns-3 role, in miniature).

The analytic simulator (simulator.py) evaluates the closed-form cost model.
This module cross-checks it with a chunk-level discrete-event simulation on
the explicit link graph: messages are split into chunks (MTU-like knob),
links serve one chunk at a time (FIFO), chunks store-and-forward with
per-hop latency alpha_h, and a step completes when every destination holds
its full message.  Reconfigurations pause the fabric for delta.

Relationship to the cost model (tested in tests/test_eventsim.py):
  - with many chunks, pipelining makes the event time converge to
    alpha_h * h + beta * m * c  per step (c = h for uniform-offset ring
    traffic): the Section 2 model is exactly the fluid limit;
  - with one chunk (no pipelining) it degrades to h * (alpha_h + beta*m),
    bracketing the model from above.

This is the reproduction-honesty layer: BRIDGE/baseline *ratios* measured at
event level must match the analytic figures (Figs 5-12) within tolerance.

`collective_time_event` is a thin compatibility wrapper over
`fabricsim.FabricSim` in full-pause mode (synchronized steps, whole-fabric
delta pauses); the asynchronous per-link fabric with sparse reconfiguration
and overlap credit lives in `fabricsim.py`.
"""
from __future__ import annotations

import dataclasses
import heapq

from .cost_model import CostModel
from .schedules import Schedule


@dataclasses.dataclass(frozen=True)
class EventStepResult:
    completion: float
    max_link_busy: float
    chunks_moved: int


def simulate_step(
    n: int,
    link_offset: int,
    msg_offset: int,
    nbytes: float,
    cm: CostModel,
    chunks_per_msg: int = 32,
    link_speed: list[float] | None = None,
) -> EventStepResult:
    """One synchronized communication step on topology {u -> u+link_offset}.

    Every node u sends `nbytes` to (u + msg_offset) % n, routed along the
    uniform-offset links (store-and-forward).  Returns the completion time
    (excluding alpha_s, added by the caller).

    link_speed[u]: relative rate of the optical egress at node u (1.0 =
    nominal; < 1 models a degraded transceiver / straggler).
    """
    if msg_offset % link_offset:
        raise ValueError("destination unreachable on this topology")
    if link_speed is not None and len(link_speed) != n:
        raise ValueError(
            f"link_speed has length {len(link_speed)} != n={n}; per-node "
            f"rates would be misattributed")
    hops = msg_offset // link_offset
    if hops == 0 or nbytes <= 0:
        return EventStepResult(0.0, 0.0, 0)
    k = max(1, int(chunks_per_msg))
    chunk = nbytes / k
    speed = link_speed if link_speed is not None else [1.0] * n

    # event = (time, seq, node, chunk_id, hops_done); links serve FIFO.
    link_free = [0.0] * n            # link u: u -> (u + link_offset) % n
    done_at = [0.0] * n              # per source message completion
    heap: list[tuple[float, int, int, int, int]] = []
    seq = 0
    for u in range(n):
        for c in range(k):
            heapq.heappush(heap, (0.0, seq, u, c, 0))
            seq += 1
    while heap:
        t, _, src, c, h = heapq.heappop(heap)
        node = (src + h * link_offset) % n
        tx = chunk * cm.beta / speed[node]
        start = max(t, link_free[node])
        arrive = start + tx + cm.alpha_h
        link_free[node] = start + tx
        if h + 1 == hops:
            done_at[src] = max(done_at[src], arrive)
        else:
            heapq.heappush(heap, (arrive, seq, src, c, h + 1))
            seq += 1
    return EventStepResult(
        completion=max(done_at),
        max_link_busy=max(link_free),
        chunks_moved=n * k * hops,
    )


def collective_time_event(
    schedule: Schedule,
    m: float,
    cm: CostModel,
    chunks_per_msg: int = 32,
    link_speed: list[float] | None = None,
) -> float:
    """Event-level completion time of a Bruck collective under a schedule.

    Thin compatibility wrapper: synchronized steps with whole-fabric delta
    pauses, i.e. `fabricsim.FabricSim` in full-pause mode (bit-stable with
    the pre-FabricSim implementation).  Use `FabricSim(mode="sparse")` for
    the asynchronous per-link fabric with sparse reconfiguration.

    Per-call overhead is one FabricSim construction: the step sequence,
    per-step link offsets, and changed-boundary structure all come from the
    schedule's memoized playback tape (`batchsim.compile_tape`), so sweep
    loops no longer re-derive `steps_for` / segment gcds on every call.
    """
    from .fabricsim import FabricSim  # deferred: fabricsim imports simulate_step

    sim = FabricSim(chunks_per_msg=chunks_per_msg, link_speed=link_speed,
                    mode="full-pause")
    return sim.run(schedule, m, cm).completion


def ring_allreduce_event(n: int, m: float, cm: CostModel) -> float:
    """Event-level RING allreduce: 2(n-1) neighbor steps of m/n."""
    total = 0.0
    for _ in range(2 * (n - 1)):
        total += cm.alpha_s
        total += simulate_step(n, 1, 1, m / n, cm, chunks_per_msg=1).completion
    return total

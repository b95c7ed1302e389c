"""Typed fault timelines and degraded fabric state.

Every run of the fabric simulators today finishes on the topology it
started with.  BRIDGE's premise — circuits are *reused* across future
steps — makes that assumption load-bearing: a single failed port or link
invalidates not just the current step but every downstream segment that
counted on the subring.  This module is the typed producer of that
situation:

  - `FaultSpec`     : one fault — a permanent link/port failure
    (``link-down``), a transient flap with a repair time (``link-flap``),
    a graceful departure (``node-leave``), or a node joining the world
    (``node-join``) — at an arbitrary time into a trace.
  - `FaultTimeline` : a time-sorted sequence of faults against one world
    size, with a delivery policy for in-flight chunks and a strict JSON
    round trip (`core.jsonio` loaders: unknown keys, bad kinds, and
    out-of-range nodes fail at the parse boundary).
  - `DegradedState` : what the engines surface when a fault takes effect —
    the surviving members and link offset, the dead-port mask, the
    committed-prefix `FabricSnapshot`, and the in-flight chunks lost or
    re-queued per the timeline's delivery policy.  This is the input to
    the recovery loop in `repro_torch.workloads.recovery`.

Fault semantics (phase granularity — a collective aborts or drains as a
unit, mirroring how real collectives abort-and-restart on member failure):

  - *abrupt* faults (``link-down``, ``link-flap``) strike at their event
    time: phases fully drained before the fault are committed, the phase
    in flight is aborted, and its already-serviced chunks are lost or
    re-queued per the delivery policy.  ``link-down`` removes the node
    from the world (its egress circuit is dead); ``link-flap`` keeps the
    world intact but delays resumption by ``repair_s``.
  - *graceful* faults (``node-leave``, ``node-join``) take effect at the
    first collective boundary at/after their time: the in-flight phase
    drains, nothing is lost, and the world shrinks/grows at the boundary.

A timeline may hold several faults; one engine run acts on the *earliest*
fault that takes effect before the clean run completes (recovery re-plans
the remainder, after which the residual timeline can be applied to the
recovered run).  Faults at/after trace completion are no-ops.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random

from .batchsim import FabricSnapshot
from .jsonio import require_keys

FAULT_KINDS = ("link-down", "link-flap", "node-leave", "node-join")
#: kinds that abort the in-flight phase at their event time
ABRUPT_KINDS = ("link-down", "link-flap")
#: what happens to the aborted phase's already-serviced chunks
DELIVERY_POLICIES = ("drop", "requeue")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault event (see module docstring for the kind semantics).

    time     : seconds into the trace at which the fault occurs.
    node     : affected node/port.  For ``node-join`` it is the index the
               joining node takes (always the current world size n — rings
               grow at the end).
    repair_s : ``link-flap`` only — time until the flapped link carries
               traffic again; resumption waits it out.
    """

    kind: str
    time: float
    node: int
    repair_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        object.__setattr__(self, "time", float(self.time))
        object.__setattr__(self, "repair_s", float(self.repair_s))
        if not math.isfinite(self.time) or self.time < 0:
            raise ValueError(
                f"fault time must be finite and >= 0, got {self.time}")
        if int(self.node) != self.node or self.node < 0:
            raise ValueError(f"fault node must be an int >= 0, got {self.node}")
        object.__setattr__(self, "node", int(self.node))
        if not math.isfinite(self.repair_s) or self.repair_s < 0:
            raise ValueError(
                f"repair_s must be finite and >= 0, got {self.repair_s}")
        if self.repair_s > 0 and self.kind != "link-flap":
            raise ValueError(
                f"repair_s only applies to link-flap faults, got "
                f"repair_s={self.repair_s} for {self.kind!r}")

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "time": self.time, "node": self.node}
        if self.repair_s:
            d["repair_s"] = self.repair_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        require_keys(d, required=("kind", "time", "node"),
                     optional=("repair_s",), what="FaultSpec")
        return cls(kind=d["kind"], time=d["time"], node=d["node"],
                   repair_s=d.get("repair_s", 0.0))


@dataclasses.dataclass(frozen=True)
class FaultTimeline:
    """Time-sorted fault sequence against one world size (strict JSON).

    policy : delivery policy for the aborted phase's in-flight chunks —
             ``"drop"`` (lost; the aborted event re-runs in full on
             recovery) or ``"requeue"`` (accounted as re-queued; the
             aborted event still re-runs in full, recovery never trusts
             partially-delivered collective state).
    """

    n: int
    faults: tuple[FaultSpec, ...]
    policy: str = "drop"

    def __post_init__(self):
        if self.n < 2:
            raise ValueError(f"need at least 2 nodes, got n={self.n}")
        if self.policy not in DELIVERY_POLICIES:
            raise ValueError(
                f"policy must be one of {DELIVERY_POLICIES}, got "
                f"{self.policy!r}")
        object.__setattr__(self, "faults", tuple(self.faults))
        if not self.faults:
            raise ValueError("a fault timeline needs at least one fault")
        for a, b in zip(self.faults, self.faults[1:], strict=False):
            if b.time < a.time:
                raise ValueError(
                    f"faults must be sorted by time, got {b.time} after "
                    f"{a.time}")
        for f in self.faults:
            if f.kind == "node-join":
                if f.node != self.n:
                    raise ValueError(
                        f"node-join joins at index n={self.n}, got node="
                        f"{f.node}")
            elif not 0 <= f.node < self.n:
                raise ValueError(
                    f"fault node {f.node} outside [0, {self.n})")

    def to_dict(self) -> dict:
        return {"n": self.n, "policy": self.policy,
                "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultTimeline":
        require_keys(d, required=("n", "faults"), optional=("policy",),
                     what="FaultTimeline")
        return cls(n=d["n"],
                   faults=tuple(FaultSpec.from_dict(f) for f in d["faults"]),
                   policy=d.get("policy", "drop"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "FaultTimeline":
        return cls.from_dict(json.loads(s))

    def check_horizon(self, horizon_s: float) -> "FaultTimeline":
        """Reject fault times at/after the trace horizon (they are no-ops —
        loading such a spec is a mistake, not a degraded run)."""
        for f in self.faults:
            if f.time >= horizon_s:
                raise ValueError(
                    f"fault time {f.time} is outside the trace horizon "
                    f"{horizon_s:.6g}s (the fault would never take effect)")
        return self


def random_timeline(n: int, *, horizon_s: float, seed: int = 0,
                    kinds: tuple[str, ...] = FAULT_KINDS, count: int = 1,
                    policy: str = "drop") -> FaultTimeline:
    """Seeded random timeline: ``count`` faults uniform over the horizon."""
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    rng = random.Random(seed)
    faults = []
    for _ in range(count):
        kind = rng.choice(list(kinds))
        faults.append(FaultSpec(
            kind=kind, time=rng.uniform(0.0, horizon_s) * (1 - 1e-12),
            node=n if kind == "node-join" else rng.randrange(n),
            repair_s=(rng.uniform(0.0, 0.1) * horizon_s
                      if kind == "link-flap" else 0.0)))
    faults.sort(key=lambda f: f.time)
    return FaultTimeline(n=n, faults=tuple(faults), policy=policy)


def world_after(n: int, fault: FaultSpec) -> tuple[tuple[int, ...],
                                                   tuple[int, ...]]:
    """(survivors, dead_ports) after ``fault`` strikes an n-node world.

    Survivors are old-world member indices (``node-join`` appends index n);
    dead_ports are ports whose egress circuit can never carry traffic again
    (``link-down`` only — a repaired flap leaves no dead circuit).
    """
    if fault.kind in ("link-down", "node-leave"):
        survivors = tuple(i for i in range(n) if i != fault.node)
        dead = (fault.node,) if fault.kind == "link-down" else ()
        return survivors, dead
    if fault.kind == "node-join":
        return tuple(range(n + 1)), ()
    return tuple(range(n)), ()  # link-flap: world intact after repair


@dataclasses.dataclass(frozen=True)
class DegradedState:
    """Fabric state surfaced by a run that a fault cut short.

    fault            : the fault that took effect (earliest effective one).
    policy           : delivery policy applied to the in-flight chunks.
    n                : world size the run started with.
    survivors        : member indices after the fault (`world_after`).
    dead_ports       : ports whose circuit is permanently dead.
    completed_phases : trace phases fully drained before the fault took
                       effect (committed — recovery never re-runs them).
    aborted_phase    : index of the phase cut mid-flight (abrupt faults;
                       ``None`` for graceful faults, which drain it).
    resume_clock     : earliest time recovery work can start — the fault
                       time (+ ``repair_s`` for a flap) for abrupt faults,
                       the drained boundary's clock for graceful ones.
    snapshot         : exact committed-prefix `FabricSnapshot` (old world;
                       ``None`` when the fault struck before any boundary).
    committed_chunks : chunk services belonging to committed phases.
    in_flight_chunks : aborted-phase services started before the fault.
    lost_chunks /
    requeued_chunks  : the in-flight split per ``policy`` (drop → all lost,
                       requeue → all re-queued; they always sum to
                       ``in_flight_chunks``, and the aborted event re-runs
                       in full on recovery either way).
    """

    fault: FaultSpec
    policy: str
    n: int
    survivors: tuple[int, ...]
    dead_ports: tuple[int, ...]
    completed_phases: int
    aborted_phase: int | None
    resume_clock: float
    snapshot: FabricSnapshot | None
    committed_chunks: int
    in_flight_chunks: int
    lost_chunks: int
    requeued_chunks: int

    @property
    def new_n(self) -> int:
        """World size the recovery plan targets."""
        return len(self.survivors)

    @property
    def link_offset(self) -> int | None:
        """Surviving link offset (the circuit the committed prefix parked
        every port on), or ``None`` when nothing committed."""
        return None if self.snapshot is None else self.snapshot.link_offset

    def dead_port_mask(self) -> tuple[bool, ...]:
        """Length-n mask: True where the port's circuit is dead."""
        dead = set(self.dead_ports)
        return tuple(i in dead for i in range(self.n))


# --- checkpoint helpers (FabricSnapshot <-> array tree) ------------------------


def snapshot_to_tree(snap: FabricSnapshot) -> dict:
    """`FabricSnapshot` as a flat array tree for `repro_torch.checkpoint.store`."""
    import numpy as np

    return {
        "n": np.array(snap.n, dtype=np.int64),
        "link_offset": np.array(snap.link_offset, dtype=np.int64),
        "node_ready": np.array(snap.node_ready, dtype=np.float64),
        "port_free": np.array(snap.port_free, dtype=np.float64),
        "chunks_moved": np.array(snap.chunks_moved, dtype=np.int64),
        "reconfigs_paid": np.array(snap.reconfigs_paid, dtype=np.int64),
        "delta_stall": np.array(snap.delta_stall, dtype=np.float64),
    }


def tree_to_snapshot(tree: dict) -> FabricSnapshot:
    """Inverse of `snapshot_to_tree` (accepts `store.restore` output, whose
    keys carry the pytree path prefix)."""
    def leaf(name):
        for k, v in tree.items():
            if k.strip("'[]\"") == name or k.endswith(f"'{name}']"):
                return v
        raise KeyError(f"checkpoint tree missing {name!r}")

    return FabricSnapshot(
        n=int(leaf("n")), link_offset=int(leaf("link_offset")),
        node_ready=tuple(float(t) for t in leaf("node_ready")),
        port_free=tuple(float(t) for t in leaf("port_free")),
        chunks_moved=int(leaf("chunks_moved")),
        reconfigs_paid=int(leaf("reconfigs_paid")),
        delta_stall=float(leaf("delta_stall")))


def latest_snapshot(directory: str) -> FabricSnapshot | None:
    """Newest checkpointed `FabricSnapshot` under ``directory`` (written by
    `FabricSim.run_trace(..., checkpoint_dir=...)`), or None if empty."""
    from repro_torch.checkpoint import store  # deferred: store imports jax

    step = store.latest_step(directory)
    if step is None:
        return None
    return tree_to_snapshot(store.restore(directory, step))

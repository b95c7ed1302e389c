"""Typed collective-event traces and deterministic workload generators.

A `Trace` is a sequence of `CollectiveEvent`s (kind + payload) issued
back-to-back on one n-node reconfigurable fabric.  The generators below
synthesize realistic streams from the model-zoo configs rather than from
hand-picked payloads:

  - `moe_a2a_trace`    — per-MoE-layer dispatch + combine All-to-All (token
                         routing), payloads from (tokens/device) x d_model
                         with seeded routing-imbalance jitter
                         (`configs/qwen3_moe_235b_a22b.py`-style shapes);
  - `train_step_trace` — per-training-step bucketed gradient AllReduce,
                         payloads from an analytic parameter-count estimate
                         of the arch (the `train_lm` gradient-sync path);
  - `decode_ag_trace`  — decode-time AllGather bursts, one small
                         hidden-state gather per emitted token (the
                         `serve_decode` path);
  - `mixed_trace`      — interleaved training + serving stream for the
                         cross-collective carryover benchmark.

All generators are deterministic in ``seed`` (payload jitter comes from one
`random.Random(seed)` stream) and every record round-trips through JSON
losslessly (floats survive via repr).
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Sequence

from repro_torch.core.jsonio import require_keys, require_positive_payload
from repro_torch.models.config import ArchConfig

EVENT_KINDS = ("a2a", "rs", "ag", "ar")

MB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective issued on the fabric.

    kind    : 'a2a' | 'rs' | 'ag' | 'ar' (composite AllReduce = RS then AG).
    m_bytes : total per-node payload in bytes (the paper's m).
    tag     : free-form provenance label, e.g. 'moe-a2a[L3:dispatch]'.
    """

    kind: str
    m_bytes: float
    tag: str = ""

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"kind must be one of {EVENT_KINDS}, got {self.kind!r}")
        if self.m_bytes < 0:
            raise ValueError(f"payload must be >= 0, got {self.m_bytes}")
        object.__setattr__(self, "m_bytes", float(self.m_bytes))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "m_bytes": self.m_bytes, "tag": self.tag}

    @staticmethod
    def from_dict(d: dict) -> "CollectiveEvent":
        require_keys(d, required=("kind", "m_bytes"), optional=("tag",),
                     what="CollectiveEvent")
        return CollectiveEvent(
            kind=d["kind"],
            m_bytes=require_positive_payload(d["m_bytes"], "CollectiveEvent"),
            tag=d.get("tag", ""))


@dataclasses.dataclass(frozen=True)
class Trace:
    """A back-to-back collective stream on one n-node fabric.

    The Bruck radix ``r`` is shared by every event (all schedules of one
    trace run on the same fabric and planner family tables).
    """

    name: str
    n: int
    events: tuple[CollectiveEvent, ...]
    r: int = 2

    def __post_init__(self):
        if self.n < 2:
            raise ValueError(f"need at least 2 nodes, got n={self.n}")
        if self.r < 2:
            raise ValueError(f"radix must be >= 2, got r={self.r}")
        if not self.events:
            raise ValueError("a trace needs at least one event")
        object.__setattr__(self, "events", tuple(self.events))

    def __len__(self) -> int:
        return len(self.events)

    def phases(self) -> tuple[tuple[str, float, str], ...]:
        """Flatten to single-collective (kind, m_bytes, tag) phases.

        A composite 'ar' event expands to its Rabenseifner RS + AG phases;
        the RS->AG transition then becomes an ordinary carryover boundary in
        the trace planner and fabric playback.
        """
        out: list[tuple[str, float, str]] = []
        for ev in self.events:
            if ev.kind == "ar":
                out.append(("rs", ev.m_bytes, f"{ev.tag}:rs"))
                out.append(("ag", ev.m_bytes, f"{ev.tag}:ag"))
            else:
                out.append((ev.kind, ev.m_bytes, ev.tag))
        return tuple(out)

    def total_bytes(self) -> float:
        return sum(ev.m_bytes for ev in self.events)

    def to_dict(self) -> dict:
        return {"version": 1, "name": self.name, "n": self.n, "r": self.r,
                "events": [ev.to_dict() for ev in self.events]}

    @staticmethod
    def from_dict(d: dict) -> "Trace":
        require_keys(d, required=("name", "n", "events"),
                     optional=("r", "version"), what="Trace")
        return Trace(name=d["name"], n=d["n"], r=d.get("r", 2),
                     events=tuple(CollectiveEvent.from_dict(e)
                                  for e in d["events"]))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "Trace":
        return Trace.from_dict(json.loads(s))


# --- payload derivation from model configs -----------------------------------


def _arch(arch: str | ArchConfig) -> ArchConfig:
    if isinstance(arch, ArchConfig):
        return arch
    from repro_torch import configs  # deferred: keep workloads importable standalone

    return configs.get(arch)


def approx_param_bytes(cfg: ArchConfig, dtype_bytes: int = 4) -> float:
    """Analytic parameter-footprint estimate of an arch (gradient AR payload).

    Embedding + per-layer attention and FFN weights; MoE layers count every
    expert (all-expert gradients sync in the dense data-parallel path).  An
    estimate, not a checkpoint census — trace payloads only need realistic
    magnitudes and ratios.
    """
    d = cfg.d_model
    head_dim = cfg.head_dim or d // cfg.num_heads
    attn = d * head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    if cfg.ffn == "moe" and cfg.moe is not None:
        ffn = 3 * d * cfg.moe.d_ff_expert * cfg.moe.num_experts
        if cfg.moe.dense_residual_d_ff:
            ffn += 3 * d * cfg.moe.dense_residual_d_ff
    else:
        ffn = 3 * d * cfg.d_ff
    return float(dtype_bytes) * (cfg.vocab_size * d + cfg.num_layers * (attn + ffn))


def moe_a2a_trace(n: int, *, arch: str | ArchConfig = "qwen3-moe-235b-a22b",
                  layers: int = 4, tokens_per_device: int = 1024,
                  act_bytes: int = 2, seed: int = 0,
                  jitter: float = 0.25, name: str | None = None) -> Trace:
    """Per-MoE-layer dispatch + combine All-to-All stream.

    Every MoE layer routes each device's tokens to their experts (dispatch
    a2a) and returns the expert outputs (combine a2a); the nominal per-node
    payload is tokens_per_device x d_model x act_bytes, scaled per event by
    a seeded routing-imbalance jitter in [1 - jitter, 1 + jitter].
    """
    cfg = _arch(arch)
    if cfg.ffn != "moe" or cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE layers (ffn={cfg.ffn!r})")
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    layers = min(layers, cfg.num_layers)
    rng = random.Random(seed)
    nominal = tokens_per_device * cfg.d_model * act_bytes
    events = []
    for layer in range(layers):
        for stage in ("dispatch", "combine"):
            scale = 1.0 + jitter * rng.uniform(-1.0, 1.0)
            events.append(CollectiveEvent(
                kind="a2a", m_bytes=nominal * scale,
                tag=f"moe-a2a[L{layer}:{stage}]"))
    return Trace(name=name or f"moe-{cfg.name}", n=n, events=tuple(events))


def train_step_trace(n: int, *, arch: str | ArchConfig = "stablelm-3b",
                     steps: int = 2, buckets: int = 2, grad_bytes: int = 4,
                     scale_down: float = 1e-3, seed: int = 0,
                     name: str | None = None) -> Trace:
    """Per-training-step bucketed gradient AllReduce stream (`train_lm`).

    Each step emits ``buckets`` composite AR events covering the arch's
    (scaled) parameter footprint — the overlapped bucket sync of a data-
    parallel training loop.  ``scale_down`` shrinks the analytic footprint
    to benchmark-friendly payloads (the default maps a ~3B arch to a few
    tens of MB per bucket, the reduced-model regime of examples/train_lm).
    """
    if steps < 1 or buckets < 1:
        raise ValueError("need steps >= 1 and buckets >= 1")
    cfg = _arch(arch)
    del seed  # payloads are structural; accepted for interface symmetry
    per_bucket = approx_param_bytes(cfg, grad_bytes) * scale_down / buckets
    events = [
        CollectiveEvent(kind="ar", m_bytes=per_bucket,
                        tag=f"grad-ar[s{step}:b{bucket}]")
        for step in range(steps) for bucket in range(buckets)
    ]
    return Trace(name=name or f"train-{cfg.name}", n=n, events=tuple(events))


def decode_ag_trace(n: int, *, arch: str | ArchConfig = "gemma3-4b",
                    decode_steps: int = 8, batch: int = 8,
                    act_bytes: int = 2, seed: int = 0, jitter: float = 0.0,
                    name: str | None = None) -> Trace:
    """Decode-time AllGather burst (`serve_decode`): one hidden-state gather
    per emitted token across the serving group, optionally jittered to model
    ragged batches."""
    if decode_steps < 1 or batch < 1:
        raise ValueError("need decode_steps >= 1 and batch >= 1")
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    cfg = _arch(arch)
    rng = random.Random(seed)
    nominal = batch * cfg.d_model * act_bytes
    events = []
    for step in range(decode_steps):
        scale = 1.0 + jitter * rng.uniform(-1.0, 1.0)
        events.append(CollectiveEvent(kind="ag", m_bytes=nominal * scale,
                                      tag=f"decode-ag[t{step}]"))
    return Trace(name=name or f"decode-{cfg.name}", n=n, events=tuple(events))


def mixed_trace(n: int, *, seed: int = 0, moe_layers: int = 2,
                train_steps: int = 1, decode_steps: int = 4,
                name: str = "mixed") -> Trace:
    """Interleaved training + serving stream: MoE a2a pairs, then the step's
    gradient AR buckets, then a decode AG burst — the trace-bench workload."""
    moe = moe_a2a_trace(n, layers=moe_layers, seed=seed)
    train = train_step_trace(n, steps=train_steps, seed=seed)
    decode = decode_ag_trace(n, decode_steps=decode_steps, seed=seed,
                             jitter=0.25)
    return Trace(name=name, n=n,
                 events=moe.events + train.events + decode.events)


def concat_traces(name: str, traces: Sequence[Trace]) -> Trace:
    """Concatenate traces issued on the same fabric into one stream."""
    if not traces:
        raise ValueError("need at least one trace")
    n, r = traces[0].n, traces[0].r
    for t in traces:
        if t.n != n or t.r != r:
            raise ValueError(
                f"trace {t.name!r} has (n={t.n}, r={t.r}) != ({n}, {r})")
    return Trace(name=name, n=n, r=r,
                 events=tuple(ev for t in traces for ev in t.events))

"""Shared strict-JSON-loader helpers and the typed request vocabulary.

Every ``from_dict`` loader in the repo (traces, plan requests/results, serve
requests, shared-fabric requests) validates its payload through these before
constructing objects: unknown fields and missing required fields fail *at
the loader* with a `ValueError` naming the offending keys, instead of
deferring to an obscure KeyError/TypeError deep inside a constructor — a
corrupted or version-skewed cached artifact should be rejected at the trust
boundary it crosses, not half-loaded.

This module is also the home of the request vocabulary shared by every
request dataclass in the repo (`repro.planner.api.PlanRequest`,
`repro.workloads.serve.ServeRequest`,
`repro.workloads.tenancy.SharedFabricRequest`):

  - `FabricKind`  : the typed fabric selector that replaced the string
                    literals ``"static" | "ocs" | "ocs-overlap" | "ocs-sim"``
                    (bare strings still coerce, with a `DeprecationWarning`);
  - `SharingMode` : how K tenants share one fabric (`repro.workloads
                    .tenancy`): disjoint port partitions or whole-collective
                    time slices;
  - `RequestBase` : the validated base every request dataclass mixes in —
                    the n / r / m_bytes / CostModel / fabric / budget
                    validators and the CostModel (de)serialization are
                    defined once here, not re-grown per request type.

Both enums are ``str`` subclasses, so existing comparisons against the
literal values (``req.fabric == "ocs"``, membership in tuples of strings)
and ``json.dumps`` keep working unchanged; loaders round-trip them
losslessly (`to_dict` emits the plain value, `from_dict` re-coerces without
a warning — a stored artifact is canonical serialization, not deprecated
call-site usage).
"""
from __future__ import annotations

import dataclasses
import enum
import json
import warnings
from typing import TYPE_CHECKING, Mapping, Sequence

if TYPE_CHECKING:  # annotation-only: no import cycle with cost_model
    from .cost_model import CostModel


class _CoercibleStrEnum(str, enum.Enum):
    """str-valued enum with a deprecation-warning coercion shim."""

    # keep the *value* as the str()/f-string rendering on every Python
    # version (3.11 changed mixin-enum __str__/__format__ semantics)
    __str__ = str.__str__
    __format__ = str.__format__

    @classmethod
    def _noun(cls) -> str:
        """Human name used in validation messages (e.g. 'fabric')."""
        return cls.__name__

    @classmethod
    def coerce(cls, value, *, warn: bool = True):
        """Coerce ``value`` (member or bare string) to a member.

        Bare strings are accepted for compatibility but emit a
        `DeprecationWarning` unless ``warn=False`` (JSON loaders pass
        ``warn=False``: a stored artifact's string is the canonical
        serialization, not a deprecated call site).
        """
        if isinstance(value, cls):
            return value
        try:
            member = cls(value)
        except ValueError:
            raise ValueError(
                f"{cls._noun()} must be one of "
                f"{tuple(m.value for m in cls)}, got {value!r} "
                f"(pass a {cls.__name__} member)") from None
        if warn:
            warnings.warn(
                f"passing the bare string {value!r} is deprecated; pass "
                f"{cls.__name__}.{member.name} (from repro.planner.api)",
                DeprecationWarning, stacklevel=3)
        return member


class FabricKind(_CoercibleStrEnum):
    """Which fabric model a request is planned against.

    STATIC      : no OCS — only R=0 schedules are feasible.
    OCS         : reconfigurable fabric, flat delta per reconfiguration
                  (the paper's setting).
    OCS_OVERLAP : sparse reconfiguration with reconfiguration/communication
                  overlap (`CostModel.delta_sparse` per boundary).
    OCS_SIM     : event-scored planning through the vectorized batch fabric
                  engine (`core.batchsim`).
    """

    STATIC = "static"
    OCS = "ocs"
    OCS_OVERLAP = "ocs-overlap"
    OCS_SIM = "ocs-sim"

    @classmethod
    def _noun(cls) -> str:
        return "fabric"


class SharingMode(_CoercibleStrEnum):
    """How K concurrent tenants share one optical fabric.

    PORT_PARTITION : each tenant owns a disjoint subset of the fabric's
                     ports and runs its trace on its own sub-fabric; no
                     cross-tenant interference (isolation ratio 1.0).
    TIME_SLICE     : tenants interleave whole collectives on the full
                     fabric; tenant hand-offs are carryover boundaries
                     priced sparsely on the circuits that actually change.
    """

    PORT_PARTITION = "port-partition"
    TIME_SLICE = "time-slice"

    @classmethod
    def _noun(cls) -> str:
        return "sharing mode"


def require_keys(d: Mapping, *, required: Sequence[str],
                 optional: Sequence[str] = (), what: str = "object") -> None:
    """Reject payloads with missing required or unknown keys."""
    if not isinstance(d, Mapping):
        raise ValueError(f"{what} payload must be a JSON object, got "
                         f"{type(d).__name__}")
    missing = [k for k in required if k not in d]
    if missing:
        raise ValueError(f"{what} payload is missing required "
                         f"field(s) {missing}")
    allowed = set(required) | set(optional)
    unknown = sorted(k for k in d if k not in allowed)
    if unknown:
        raise ValueError(
            f"{what} payload has unknown field(s) {unknown}; expected a "
            f"subset of {sorted(allowed)}")


def validate_world(n: int, what: str = "request") -> int:
    """World sizes are >= 2 everywhere a collective is planned."""
    if n < 2:
        raise ValueError(f"{what}: need at least 2 nodes, got n={n}")
    return int(n)


def validate_radix(r: int, what: str = "request") -> int:
    if r < 2:
        raise ValueError(f"{what}: radix must be >= 2, got r={r}")
    return int(r)


def validate_payload_nonneg(m_bytes, what: str = "request") -> float:
    """In-memory payloads may be zero (padding phases); negatives never."""
    m = float(m_bytes)
    if m < 0:
        raise ValueError(f"{what}: payload must be >= 0, got m_bytes={m_bytes}")
    return m


def validate_budget(delta_budget, what: str = "request"):
    if delta_budget is not None and delta_budget < 0:
        raise ValueError(
            f"{what}: delta_budget must be >= 0, got {delta_budget}")
    return delta_budget


def validate_overlap(overlap: float, fabric, what: str = "request") -> float:
    """Overlap is a [0, 1] fraction, meaningful only on overlap fabrics."""
    if not 0.0 <= overlap <= 1.0:
        raise ValueError(f"{what}: overlap must be in [0, 1], got {overlap}")
    if overlap > 0.0 and fabric not in (FabricKind.OCS_OVERLAP,
                                        FabricKind.OCS_SIM):
        raise ValueError(
            f"{what}: overlap={overlap} requires fabric="
            f"'ocs-overlap' or 'ocs-sim', got fabric={str(fabric)!r}")
    return float(overlap)


def validate_init_g(init_g, fabric=None, what: str = "request"):
    """Inherited link offsets are positive, and need a reconfigurable fabric."""
    if init_g is None:
        return None
    if fabric is not None and fabric == FabricKind.STATIC:
        raise ValueError(
            f"{what}: init_g (inherited fabric state) requires a "
            f"reconfigurable fabric; a static fabric has no circuits to "
            f"carry over")
    if init_g < 1:
        raise ValueError(
            f"{what}: init_g must be a positive link offset, got {init_g}")
    return int(init_g)


def cost_model_to_dict(cm: "CostModel") -> dict:
    return {"alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h,
            "bandwidth": cm.bandwidth, "delta": cm.delta}


def cost_model_from_dict(d: dict, what: str = "request") -> "CostModel":
    from .cost_model import CostModel  # deferred: jsonio must stay leaf-like

    require_keys(d, required=("alpha_s", "alpha_h", "bandwidth", "delta"),
                 what=f"{what}.cost_model")
    return CostModel(**d)


class RequestBase:
    """Validated base mixed into every request dataclass in the repo.

    Centralizes what `PlanRequest`, `ServeRequest`, and
    `SharedFabricRequest` used to each re-implement: the n / r / payload /
    budget / fabric / overlap validators (the ``validate_*`` helpers above)
    and the JSON envelope (`to_json` / `from_json` over the subclass's
    `to_dict` / `from_dict`).  Subclasses stay plain frozen dataclasses —
    the base deliberately declares no fields, so each request keeps its
    established field order and positional-construction compatibility.
    """

    def to_dict(self) -> dict:  # pragma: no cover - subclasses override
        raise NotImplementedError

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict):  # pragma: no cover - subclasses override
        raise NotImplementedError

    def _coerce_fabric(self, field: str = "fabric") -> None:
        """Coerce a dataclass fabric field in place (bare strings warn)."""
        value = getattr(self, field)
        object.__setattr__(self, field, FabricKind.coerce(value))

    def _validate_base(self) -> None:
        """Validate whichever of the shared fields this request declares."""
        what = type(self).__name__
        fields = {f.name for f in dataclasses.fields(self)}
        if "n" in fields:
            validate_world(self.n, what)
        if "r" in fields:
            validate_radix(self.r, what)
        if "m_bytes" in fields:
            object.__setattr__(
                self, "m_bytes", validate_payload_nonneg(self.m_bytes, what))
        if "delta_budget" in fields:
            validate_budget(self.delta_budget, what)
        if "fabric" in fields:
            self._coerce_fabric()
            if "overlap" in fields:
                validate_overlap(self.overlap, self.fabric, what)
            if "init_g" in fields:
                validate_init_g(self.init_g, self.fabric, what)
        elif "init_g" in fields:
            validate_init_g(self.init_g, None, what)


def require_positive_payload(m_bytes, what: str = "object") -> float:
    """Serialized payloads must be strictly positive finite byte counts.

    (In-memory zero-byte events are legal — e.g. a padding phase — but a
    stored/shipped plan with m_bytes <= 0 is a corrupt artifact.)
    """
    try:
        m = float(m_bytes)
    except (TypeError, ValueError):
        raise ValueError(
            f"{what} payload m_bytes must be a number, got {m_bytes!r}"
        ) from None
    if not m > 0.0 or m != m or m == float("inf"):
        raise ValueError(
            f"{what} payload m_bytes must be > 0 and finite, got {m_bytes!r}")
    return m

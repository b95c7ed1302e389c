"""Structured findings of the static verifier.

Every rule the verifier checks has a stable dotted id (``tape/gcd``,
``plan/entry``, ...) catalogued in ``docs/invariants.md`` together with the
paper condition it encodes.  A finding is a `Violation` record: the rule id,
where in the artifact it fired, a human-readable message, and a small repro
snippet (enough context to reconstruct the failing check by hand).  Callers
that want hard failure semantics use `raise_on_violations`, which wraps the
findings in a `VerificationError`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One static-verification finding.

    rule     : stable rule id, e.g. 'tape/gcd' (see docs/invariants.md).
    location : where the rule fired, e.g. 'a2a n=16 step 3'.
    message  : what was expected vs what the artifact claims.
    severity : 'error' (invariant broken) or 'warning' (suspicious).
    repro    : small snippet of the offending values, for bug reports.
    """

    rule: str
    location: str
    message: str
    severity: str = "error"
    repro: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def __str__(self) -> str:
        tail = f" [{self.repro}]" if self.repro else ""
        return f"[{self.rule}] {self.location}: {self.message}{tail}"


class VerificationError(ValueError):
    """Raised when an artifact fails static verification at a trust boundary.

    Carries the full list of findings; str() renders them one per line so a
    planner/serving failure log shows every broken invariant, not just the
    first.
    """

    def __init__(self, violations: Sequence[Violation], context: str = ""):
        self.violations = tuple(violations)
        self.context = context
        head = (f"{context}: " if context else "") + (
            f"{len(self.violations)} static verification failure(s)")
        lines = [head] + [f"  - {v}" for v in self.violations]
        super().__init__("\n".join(lines))


def raise_on_violations(violations: Sequence[Violation],
                        context: str = "") -> None:
    """Raise `VerificationError` iff any error-severity finding is present."""
    errors = [v for v in violations if v.severity == "error"]
    if errors:
        raise VerificationError(errors, context)

"""Static verification of schedules, tapes, plans, and fabric snapshots.

The analysis layer sits at the trust boundaries of the planning/serving
stack (see docs/architecture.md and docs/invariants.md):

  - `verifier`  : rule catalogue re-deriving every claimed invariant from
                  the link-offset algebra, no simulator involved;
  - `certifier` : static fast-path certificates replacing batchsim's
                  runtime canonical-order guards for provably-safe lanes;
  - `mutations` : the corruption harness proving each rule actually fires;
  - `violations`: the structured finding records and raise helpers.

Only `repro_torch.core` is imported at module level, so the planner and workloads
layers can depend on this package without cycles.
"""
from .certifier import (certify_batch, certify_lane, certify_trace_batch,
                        certify_trace_lane, clear_certifier_cache,
                        partition_backends)
from .verifier import (clear_verifier_caches, verify_degraded, verify_plan,
                       verify_recovery, verify_schedule, verify_served_plan,
                       verify_shared_plan, verify_snapshot, verify_tape,
                       verify_timeline, verify_trace_plan,
                       verify_window_choice)
from .violations import VerificationError, Violation, raise_on_violations

__all__ = [
    "Violation", "VerificationError", "raise_on_violations",
    "verify_schedule", "verify_tape", "verify_plan", "verify_trace_plan",
    "verify_served_plan", "verify_shared_plan", "verify_window_choice",
    "verify_snapshot",
    "verify_timeline", "verify_degraded", "verify_recovery",
    "clear_verifier_caches",
    "certify_lane", "certify_trace_lane", "certify_batch",
    "certify_trace_batch", "clear_certifier_cache", "partition_backends",
]

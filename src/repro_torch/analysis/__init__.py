"""Static analysis of the port's schedules and tapes.

Copies of the reference's `certifier` (static fast-path certificates that
replace batchsim's runtime canonical-order guards for provably-safe lanes,
and admit lanes to the card's playback) and `violations` (the structured
finding records and raise helpers), with their imports pointed at
`repro_torch`.  The verifier and the mutation harness come with ROADMAP A12.
Only `repro_torch.core` is imported at module level.
"""
from .certifier import (certify_batch, certify_lane, certify_trace_batch,
                        certify_trace_lane, clear_certifier_cache,
                        partition_backends)
from .violations import VerificationError, Violation, raise_on_violations

__all__ = [
    "Violation", "VerificationError", "raise_on_violations",
    "certify_lane", "certify_trace_lane", "certify_batch",
    "certify_trace_batch", "clear_certifier_cache", "partition_backends",
]

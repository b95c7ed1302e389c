"""The yardstick of the roofline metrics: the published peaks of one H100
SXM and the least time of a kernel call, from the operations and bytes its
inputs need (each input byte read once, each output byte written once).

A frozen copy of the port's chip check (`chip_smoke.py`: the peaks, `bound`,
the byte and FLOP counts of B1-B3 and of B5), so that a change to the program
cannot move the yardstick.  `tests/test_bench_roofline.py` holds it to the
bound_ms values PERF.md records.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates; they assume the 700 W limit
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12


def bound(moved_bytes: int, flops: int, flop_s: float = BF16_FLOP_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations"): bytes over the HBM rate against
    operations over `flop_s`, the peak of the inputs' type."""
    t_bytes = moved_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def live_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs a mask keeps, queries aligned to the last keys."""
    total = 0
    for i in range(sq):
        pos = i + sk - sq
        lo = 0 if window is None else max(0, pos - window + 1)
        hi = pos + 1 if causal else sk
        total += max(0, min(hi, sk) - lo)
    return total


def flash_fwd_work(b, hq, hkv, sq, sk, d, causal, window=None, elem=2, dv=None):
    """B1 (bytes, FLOP): q, k, v read, the output and the f32 logsumexp
    written; 2 D + 2 Dv FLOP a live pair (QK^T, PV)."""
    dv = d if dv is None else dv
    moved = (b * hq * sq * d + b * hkv * sk * d + b * hkv * sk * dv + b * hq * sq * dv) * elem \
        + b * hq * sq * 4
    return moved, 2 * (d + dv) * live_pairs(sq, sk, causal, window) * b * hq


def _bwd_reads(b, h, sq, sk, d, dv, elem):
    """q, k, v, dO read, the logsumexp and the row dot f32 (B2 and B3 read
    K and V expanded to the query heads)."""
    return (b * h * sq * d + b * h * sk * d + b * h * sk * dv + b * h * sq * dv) * elem \
        + 2 * b * h * sq * 4


def flash_bwd_dkv_work(b, h, sq, sk, d, causal, window=None, elem=2, dv=None):
    """B2 (bytes, FLOP): the reads, dK and dV written; QK^T, dO V^T, P^T dO,
    dS^T Q: 4 D + 4 Dv a live pair."""
    dv = d if dv is None else dv
    live = live_pairs(sq, sk, causal, window) * b * h
    moved = _bwd_reads(b, h, sq, sk, d, dv, elem) + (b * h * sk * d + b * h * sk * dv) * elem
    return moved, (4 * d + 4 * dv) * live


def flash_bwd_dq_work(b, h, sq, sk, d, causal, window=None, elem=2, dv=None):
    """B3 (bytes, FLOP): the reads, dQ written; QK^T, dO V^T, dS K: 4 D +
    2 Dv a live pair."""
    dv = d if dv is None else dv
    live = live_pairs(sq, sk, causal, window) * b * h
    moved = _bwd_reads(b, h, sq, sk, d, dv, elem) + b * h * sq * d * elem
    return moved, (4 * d + 2 * dv) * live


def wkv_work(b, h, t, dk, dv, with_s0: bool, elem=2) -> tuple[int, int]:
    """B5 (bytes, FLOP): r, k, v, log_w, u and s0 read once, y and the f32
    state written once; the chunked form's operations chunk by chunk (64
    steps), a multiply-add counting 2."""
    moved = (3 * b * h * t * dk + b * h * t * dv) * elem + h * dk * 4 + b * h * t * dv * elem \
        + (2 if with_s0 else 1) * b * h * dk * dv * 4
    flops = 0
    for t0 in range(0, t, 64):
        n = min(64, t - t0)
        pairs = n * (n - 1) // 2
        flops += (n * dk + 3 * (pairs + n) * dk + 2 * (pairs + n) * dv + 2 * n * dk
                  + 2 * n * dk * dv + dk * dv * (1 + 2 * n))
    return moved, flops * b * h

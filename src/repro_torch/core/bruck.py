"""Bruck communication-step structure for All-to-All / Reduce-Scatter /
AllGather, generalized to arbitrary world sizes n and radix r.

Paper Section 3.1 derives the radix-2 pattern on n = 2^s nodes; this module
implements the mixed-radix generalization that the paper's last paragraph of
Section 3.1 sketches (multiport = radix-(p+1)) and that arbitrary cluster
sizes (48, 96, 384, ...) require:

  - s = ceil(log_r n) digit *phases*; phase k has place value w_k = r^k
    (so offsets are prod of the radixes of all lower phases).
  - Phase k consists of up to r-1 *sub-steps*, one per nonzero digit value
    j in 1..r-1, with message offset j * r^k.  Steps whose digit class is
    empty for this n (j * r^k >= n) are elided.
  - All-to-All:      sub-step (k, j) moves every block whose relative
                     destination offset d = (dst - src) mod n has k-th
                     base-r digit equal to j; each block moves once per
                     nonzero digit of d, so total displacement is exactly d.
  - Reduce-Scatter:  same offsets; sub-step (k, j) forwards the partial sums
                     of blocks whose remaining offset is j * r^k + (higher
                     digits), i.e. d % r^k == 0 and digit_k(d) == j.  Data
                     shrinks every phase (recursive-r-ing).
  - AllGather:       exact time-reverse of Reduce-Scatter: descending place
                     values, data grows every phase.

For r = 2 and n = 2^s each phase has one sub-step at offset 2^k carrying
m/2 (A2A), m/2^{k+1} (RS), m/2^{s-k} (AG) — bit-identical to the paper and
to the seed implementation.  For 2^{s-1} < n < 2^s radix-2 A2A volumes are
the exact digit-class sizes (m/n)·#{d < n : bit_k(d) = 1}: the last step
carries (m/n)(n - 2^{s-1}) as in the paper, while intermediate truncated
classes carry less than the m/2 the paper's closed form assumes (the paper
only models the last step as truncated; the executable algorithm moves
exactly the digit-class blocks, so the exact counts are used throughout).

``m`` is the total per-node payload in bytes (the collective's message size
as used throughout the paper's evaluation).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np

Collective = Literal["a2a", "rs", "ag"]


def num_steps(n: int, r: int = 2) -> int:
    """Number of digit phases s = ceil(log_r n), computed exactly."""
    if n < 2:
        raise ValueError(f"need at least 2 nodes, got {n}")
    if r < 2:
        raise ValueError(f"radix must be >= 2, got {r}")
    s, v = 0, 1
    while v < n:
        v *= r
        s += 1
    return s


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def digit(d: int, k: int, r: int) -> int:
    """k-th base-r digit of d."""
    return (d // r**k) % r


def a2a_digit_count(n: int, k: int, j: int, r: int) -> int:
    """#{d in [0, n): digit_k(d) == j} — blocks moved by A2A sub-step (k, j)."""
    w = r**k
    cycle = w * r
    full = (n // cycle) * w
    rem = n % cycle
    return full + min(max(rem - j * w, 0), w)


def rs_digit_count(n: int, k: int, j: int, r: int) -> int:
    """#{d in [0, n): d % r^k == 0 and digit_k(d) == j} — RS sub-step (k, j).

    These are the blocks whose remaining relative offset at phase k starts
    with digit j: the partial sums forwarded by sub-step (k, j).
    """
    w = r**k
    t = -(-n // w)  # ceil(n / w): multiples of w below n
    return t // r + (1 if t % r > j else 0)


@dataclasses.dataclass(frozen=True)
class Step:
    """One Bruck communication sub-step: node u sends to (u + offset) mod n.

    ``phase`` is the digit position k and ``digit`` the digit value j, so
    offset == digit * r**phase for the generating radix r.
    """

    index: int
    offset: int
    nbytes: float
    phase: int = 0
    digit: int = 1


def a2a_steps(n: int, m: float, r: int = 2) -> list[Step]:
    """All-to-All sub-steps. Radix 2: constant m/2 per step (last step
    reduced for non-pow2 n); general r: (m/n) * |digit class| per sub-step."""
    s = num_steps(n, r)
    steps: list[Step] = []
    for k in range(s):
        for j in range(1, r):
            cnt = a2a_digit_count(n, k, j, r)
            if cnt == 0:
                continue
            steps.append(Step(index=len(steps), offset=j * r**k,
                              nbytes=m * cnt / n, phase=k, digit=j))
    return steps


def rs_steps(n: int, m: float, r: int = 2) -> list[Step]:
    """Reduce-Scatter sub-steps: data shrinks every phase, offsets grow
    (paper 3.4, generalized to arbitrary n / radix r)."""
    s = num_steps(n, r)
    steps: list[Step] = []
    for k in range(s):
        for j in range(1, r):
            cnt = rs_digit_count(n, k, j, r)
            if cnt == 0:
                continue
            steps.append(Step(index=len(steps), offset=j * r**k,
                              nbytes=m * cnt / n, phase=k, digit=j))
    return steps


def ag_steps(n: int, m: float, r: int = 2) -> list[Step]:
    """AllGather: exact time-reverse of Reduce-Scatter (paper 3.5).

    Radix 2 / pow2: step k has offset 2^{s-1-k} and data m/2^{s-k}
    (starts at m/n, doubles every step) — the seed's sequence.
    """
    rev = list(reversed(rs_steps(n, m, r)))
    return [dataclasses.replace(st, index=i) for i, st in enumerate(rev)]


@functools.lru_cache(maxsize=None)
def step_counts(kind: Collective, n: int, r: int = 2) -> tuple[tuple[int, int, int, int], ...]:
    """m-independent sub-step structure: (offset, block_count, phase, digit).

    The payload of sub-step k is always ``m * block_count / n`` (the digit
    class carries ``block_count`` of the n per-node blocks), so the full step
    sequence for any m is one multiplication away.  Memoized: this is what
    `steps_for` re-derived from scratch on every simulator/planner call, which
    profiling showed dominating sweep loops.
    """
    gen = {"a2a": a2a_steps, "rs": rs_steps, "ag": ag_steps}[kind]
    # Generate with m = n so nbytes == block_count exactly (integers in float).
    return tuple((st.offset, int(st.nbytes), st.phase, st.digit)
                 for st in gen(n, float(n), r))


def steps_for(kind: Collective, n: int, m: float, r: int = 2) -> list[Step]:
    """Sub-step sequence of a collective at payload m (cached structure).

    Bit-identical to calling the per-kind generators directly: the payload is
    computed as ``m * count / n`` in the same expression order.
    """
    return [Step(index=i, offset=off, nbytes=m * cnt / n, phase=ph, digit=dg)
            for i, (off, cnt, ph, dg) in enumerate(step_counts(kind, n, r))]


def schedule_length(kind: Collective, n: int, r: int = 2) -> int:
    """Number of sub-steps of a collective — the length of a Schedule's x.

    Identical for all three kinds at fixed (n, r): a digit class (k, j) is
    non-empty iff j * r^k < n, for A2A and RS alike (and AG is reversed RS).
    For r = 2 this equals num_steps(n) for every n.
    """
    s = num_steps(n, r)
    return sum(1 for k in range(s) for j in range(1, r) if j * r**k < n)


# --- Executable reference of Bruck data movement -----------------------------
#
# Used by tests to prove the *algorithm* (which blocks move at which sub-step)
# delivers every block to its destination for arbitrary n and radix r,
# regardless of the reconfiguration schedule (the schedule changes only the
# cost of a step, never its payload).


def simulate_a2a_data(n: int, r: int = 2) -> np.ndarray:
    """Run radix-r Bruck all-to-all over integer block ids; return received
    matrix.

    Node i starts with blocks ``block[i, j] = i * n + j`` destined for node j.
    Returns ``recv`` with ``recv[j, i]`` = the block node j received from
    node i.  Correct iff ``recv[j, i] == i * n + j``.
    """
    s = num_steps(n, r)
    # Phase 1 (local rotation): node i stores block for destination (i + d) % n
    # at local slot d.
    buf = np.empty((n, n), dtype=np.int64)
    for i in range(n):
        for d in range(n):
            buf[i, d] = i * n + (i + d) % n
    # Phase 2: digit phases. In sub-step (k, j), node i sends every slot d
    # whose k-th base-r digit equals j to node (i + j * r^k) % n.
    for k in range(s):
        for j in range(1, r):
            send_slots = [d for d in range(n) if digit(d, k, r) == j]
            if not send_slots:
                continue
            new_buf = buf.copy()
            for i in range(n):
                dst = (i + j * r**k) % n
                new_buf[dst, send_slots] = buf[i, send_slots]
            buf = new_buf
    # Phase 3 (inverse rotation): slot d at node i now holds the block
    # destined for i that originated at node (i - d) % n.
    recv = np.empty((n, n), dtype=np.int64)
    for i in range(n):
        for d in range(n):
            recv[i, (i - d) % n] = buf[i, d]
    return recv


def simulate_rs_data(n: int, r: int = 2) -> np.ndarray:
    """Run the Bruck-pattern reduce-scatter over one-hot contribution vectors.

    Node i contributes the indicator row e_i for every destination block.
    After reduce-scatter, node b must own block b reduced over all nodes,
    i.e. a row of all ones.  Returns ``owned`` of shape (n, n) where
    ``owned[b]`` is node b's reduced block-b vector.

    Block propagation (paper 3.4 generalized): the partial sum for block b
    held at node u travels the base-r digit decomposition of d = (b - u)
    mod n, least-significant digit first.  In sub-step (k, j), node u
    forwards every active block whose remaining offset d has zero digits
    below k and digit_k(d) == j to u + j * r^k; the receiver merges it into
    its own partial at remaining offset d - j * r^k.
    """
    s = num_steps(n, r)
    # partial[u, b, :] = current partial-sum vector node u holds for block b
    partial = np.zeros((n, n, n), dtype=np.int64)
    for u in range(n):
        partial[u, :, u] = 1  # u contributes e_u to every block
    active = [[True] * n for _ in range(n)]  # active[u][b]: u still holds b
    for k in range(s):
        w = r**k
        for j in range(1, r):
            off = j * w
            if off >= n:
                continue
            new_partial = partial.copy()
            new_active = [row[:] for row in active]
            for u in range(n):
                dst = (u + off) % n
                for b in range(n):
                    if not active[u][b]:
                        continue
                    d = (b - u) % n
                    if d % w == 0 and digit(d, k, r) == j:
                        new_partial[dst, b] += partial[u, b]
                        new_active[u][b] = False
            partial, active = new_partial, new_active
    owned = np.empty((n, n), dtype=np.int64)
    for b in range(n):
        owned[b] = partial[b, b]
    return owned


def simulate_ag_data(n: int, r: int = 2) -> np.ndarray:
    """Run the Bruck-pattern all-gather over integer block ids.

    Node i starts with its own block id i.  Returns ``held`` of shape (n, n)
    where ``held[u, p]`` is the block node u ended up holding for source p.
    Correct iff ``held[u, p] == p`` for all u, p.

    Time-reverse of reduce-scatter: descending place values; in sub-step
    (k, j) every node sends the blocks at relative offsets d with
    d % r^{k+1} == 0 and d + j * r^k < n; the receiver stores them at
    relative offset d + j * r^k.
    """
    s = num_steps(n, r)
    NONE = -1
    # buf[u, d] = block of node (u - d) mod n, or NONE if not yet held
    buf = np.full((n, n), NONE, dtype=np.int64)
    buf[:, 0] = np.arange(n)
    for k in range(s - 1, -1, -1):
        w = r**k
        for j in range(1, r):
            off = j * w
            send = [d for d in range(0, n, w * r) if d + off < n]
            if not send:
                continue
            new_buf = buf.copy()
            for u in range(n):
                dst = (u + off) % n
                for d in send:
                    assert buf[u, d] != NONE, (u, d, k, j)
                    new_buf[dst, d + off] = buf[u, d]
            buf = new_buf
    held = np.empty((n, n), dtype=np.int64)
    for u in range(n):
        for d in range(n):
            held[u, (u - d) % n] = buf[u, d]
    return held

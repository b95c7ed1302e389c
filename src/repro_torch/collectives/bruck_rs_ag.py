"""Bruck-pattern reduce-scatter and all-gather over `torch.distributed`.

The port of `repro.collectives.bruck_rs_ag`.  Both are written in *relative
block coordinates* (block r at rank i refers to global block (i + r) mod n for
RS, (i - r) mod n for AG) so every rank executes the same static slot
schedule — the cyclic symmetry that makes Bruck's pattern subring-friendly
(paper Section 3.1).

Data volumes per step match the paper exactly for power-of-two n:
  RS step k sends n / 2^{k+1} blocks  (m/2, m/4, ... — Section 3.4)
  AG step k sends 2^k blocks          (m/n, 2m/n, ... — Section 3.5)
Arbitrary group sizes are handled by the remainder rule: a slot only
participates in a step when its target coordinate exists (< n), which is the
slot-level view of the mixed-radix digit classes in `core.bruck` (empty digit
classes are simply skipped).

Each `jax.lax.ppermute` of the reference at `_shift_perm(n, off)` becomes one
`dist.batch_isend_irecv`: send to (rank + off) % n, receive from
(rank - off) % n, on contiguous buffers (NCCL on the card, gloo on the CPU).
If a BRIDGE `Schedule` is supplied, each step is lowered as h_k = offset_k / g
shifts at the segment's subring link offset g — store-and-forward along the
reusable subring links, exactly the execution the paper's cost model scores.
Without a schedule, each step is one shift at the step offset.

`group=None` is the default process group.  A group of one rank returns the
input, as n == 1 does in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.bruck import num_steps
from repro_torch.core.schedules import Schedule


def _world(group) -> tuple[int, int]:
    """(size, rank) of `group` (default: the whole world)."""
    return dist.get_world_size(group), dist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def shift(val: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """Send `val` to rank (i + offset) % n and return what rank
    (i - offset) % n sent: one collective permute at ring offset `offset`."""
    n, i = _world(group)
    val = val.contiguous()
    out = torch.empty_like(val)
    ops = [dist.P2POp(dist.isend, val, _global_rank(group, (i + offset) % n), group),
           dist.P2POp(dist.irecv, out, _global_rank(group, (i - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _permute_hops(val: torch.Tensor, group, offset: int,
                  link_offset: int) -> torch.Tensor:
    """Move val by +offset: either one shift or offset/link_offset
    store-and-forward hops along the subring links."""
    if link_offset == offset:
        return shift(val, offset, group)
    assert offset % link_offset == 0, (offset, link_offset)
    for _ in range(offset // link_offset):
        val = shift(val, link_offset, group)
    return val


def _link_offsets(schedule: Schedule | None, s: int, offsets: list[int]) -> list[int]:
    if schedule is None:
        return list(offsets)  # one shift per step
    lo = schedule.link_offsets()
    assert len(lo) == s
    return lo


def bruck_reduce_scatter(x: torch.Tensor, schedule: Schedule | None = None,
                         group=None) -> torch.Tensor:
    """x: (n, ...) local contributions; returns the sum over ranks of block i
    at rank i (shape x.shape[1:]), in ceil(log2 n) Bruck steps."""
    n, i = _world(group)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != group size {n}")
    if n == 1:
        return x[0]
    s = num_steps(n)
    link = _link_offsets(schedule, s, [2**k for k in range(s)])

    # relative coords: buf[r] = my partial for global block (i + r) mod n
    buf = x[(i + torch.arange(n, device=x.device)) % n]
    for k in range(s):
        off = 2**k
        # active rows with bit k set: r = 2^k (mod 2^{k+1}); receiver merges
        # them at r - 2^k (rows = 0 mod 2^{k+1}).  Restricting to r < n is
        # the arbitrary-n remainder rule (digit classes empty above n).
        send = torch.tensor([r for r in range(n) if r % (2 * off) == off],
                            dtype=torch.long, device=x.device)
        moved = _permute_hops(buf[send], group, off, link[k])
        buf.index_add_(0, send - off, moved)
    return buf[0]


def bruck_all_gather(x: torch.Tensor, schedule: Schedule | None = None,
                     group=None) -> torch.Tensor:
    """x: (...) local block; returns (n, ...) with row p = rank p's block, in
    ceil(log2 n) Bruck steps with *decreasing* offsets 2^{s-1-k} (paper
    Section 3.5)."""
    n, i = _world(group)
    if n == 1:
        return x[None]
    s = num_steps(n)
    offsets = [2 ** (s - 1 - k) for k in range(s)]
    link = _link_offsets(schedule, s, offsets)

    # relative coords: buf[r] = block of rank (i - r) mod n
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[0] = x
    held = [0]
    for k in range(s):
        off = offsets[k]
        # arbitrary-n remainder rule: only slots whose target coordinate
        # exists participate (time-reverse of the RS digit classes).
        send = torch.tensor([r for r in sorted(held) if r + off < n],
                            dtype=torch.long, device=x.device)
        moved = _permute_hops(buf[send], group, off, link[k])
        buf[send + off] = moved
        held = held + [r + off for r in held if r + off < n]
    assert sorted(held) == list(range(n))
    # out[p] = block from rank p = buf[(i - p) mod n]
    return buf[(i - torch.arange(n, device=x.device)) % n]

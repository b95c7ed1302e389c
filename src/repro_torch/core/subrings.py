"""Minimal connected subrings (paper Section 3.2) and topology evolution.

A topology in this model is always a *uniform-offset ring family*: the OCS
links are { u -> (u + g) mod n : all u } for a single link offset ``g``.

  g = 1      : the initial physical ring.
  g = 2^k    : the BRIDGE reconfiguration for radix-2 Bruck step k.  It
               partitions the network into gcd(g, n) = 2^k subrings
               S_i^{(k)} = { u : u = i (mod 2^k) }, each of size n / 2^k.
  g = r^k    : the radix-r generalization (and, within a segment spanning
               several digit values j * r^k, the gcd of the segment's
               message offsets).

Lemma (3.2), generalized: Topology(n, g) partitions the nodes into
gcd(g, n) subrings of size n / gcd(g, n), and a destination at message
offset ``mo`` is reachable iff g divides mo — in exactly mo / g hops
(mo < n and mo/g < n/g <= subring cycle length, so the walk never wraps).
For the paper's radix-2 power-of-two case every later offset 2^j (j >= k)
is a multiple of 2^k, so traffic never leaves the subring; for mixed-radix
schedules the segment link offset is the gcd of the segment's offsets,
which preserves the same divisibility invariant at arbitrary n.

Port-constrained networks (paper Section 3.7): with z < 2n OCS ports, blocks
of ceil(2n/z) consecutive nodes share one optical ingress/egress pair, so a
reconfiguration reduces the effective distance only to ~2n/z, not to 1.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Topology:
    """Uniform-offset ring family over n nodes with link offset g."""

    n: int
    g: int

    def __post_init__(self):
        if self.n % math.gcd(self.g, self.n) != 0:
            raise ValueError("inconsistent")
        if self.g <= 0 or self.g >= self.n:
            raise ValueError(f"link offset must be in [1, n), got g={self.g} n={self.n}")

    @property
    def num_subrings(self) -> int:
        return math.gcd(self.g, self.n)

    @property
    def subring_size(self) -> int:
        return self.n // self.num_subrings

    def successor(self, u: int) -> int:
        return (u + self.g) % self.n

    def subring_of(self, u: int) -> int:
        return u % self.num_subrings

    def subring_members(self, i: int) -> list[int]:
        """S_i = { u : u = i mod gcd(g, n) } (paper's S_i^{(k)} for g = 2^k)."""
        return [u for u in range(self.n) if u % self.num_subrings == i % self.num_subrings]

    def hops(self, src: int, dst: int, max_hops: int | None = None) -> int:
        """Directed hop count src -> dst by explicitly walking the links.

        Raises ValueError when dst is unreachable (different subring), which a
        *valid* reconfiguration schedule must never trigger.
        """
        limit = max_hops if max_hops is not None else self.n
        u, h = src, 0
        while u != dst:
            u = self.successor(u)
            h += 1
            if h > limit:
                raise ValueError(
                    f"{dst} unreachable from {src} with link offset {self.g} (n={self.n})"
                )
        return h

    def max_link_load(self, msg_offset: int) -> int:
        """Congestion factor when every node u sends one flow to u + msg_offset.

        Computed by explicit routing: each flow occupies every directed link on
        its path; returns the max number of flows sharing any link.
        """
        load: dict[tuple[int, int], int] = {}
        for src in range(self.n):
            dst = (src + msg_offset) % self.n
            u = src
            for _ in range(self.n + 1):
                if u == dst:
                    break
                v = self.successor(u)
                load[(u, v)] = load.get((u, v), 0) + 1
                u = v
            else:
                raise ValueError("unreachable destination while routing")
        return max(load.values()) if load else 0


def ring(n: int) -> Topology:
    return Topology(n=n, g=1)


def subring_topology(n: int, k: int, r: int = 2) -> Topology:
    """The BRIDGE topology after reconfiguring for Bruck phase k (offset r^k)."""
    return Topology(n=n, g=r**k)


def validate_schedule_reachability(n: int, offsets: list[int], link_offsets: list[int]) -> None:
    """Assert every step's destination is reachable on its assigned topology.

    offsets[k]      : message offset of sub-step k (j * r^k for RS/A2A,
                      reversed for AG; 2^k in the radix-2 case)
    link_offsets[k] : OCS link offset in force during sub-step k
    """
    for k, (mo, lo) in enumerate(zip(offsets, link_offsets, strict=True)):
        if mo % lo != 0:
            raise ValueError(
                f"step {k}: message offset {mo} not a multiple of link offset {lo}; "
                "destination would leave the subring"
            )
        topo = Topology(n=n, g=lo)
        # spot-check by walking from node 0 and node 1
        for src in (0, 1 % n):
            topo.hops(src, (src + mo) % n)


# --- Port-constrained extension (paper Section 3.7) -------------------------


@dataclasses.dataclass(frozen=True)
class BlockedRing:
    """Hierarchical ring: blocks of consecutive nodes share 2 OCS ports.

    With z optical ports for n nodes, blocks hold B = ceil(2n/z) nodes.
    Intra-block hops are electrical (static); only block-boundary links are
    reconfigurable.  A reconfiguration therefore reduces the effective
    distance of a step to ~B hops rather than 1 (paper 3.7).
    """

    n: int
    ports: int

    @property
    def block_size(self) -> int:
        return max(1, math.ceil(2 * self.n / self.ports))

    def effective_hops(self, msg_offset: int, link_offset: int) -> int:
        """Hops for a step with message offset given OCS links at link_offset.

        Without port limits this is msg_offset / link_offset.  With blocks of
        size B, the optical shortcut only connects block boundaries, so the
        distance floor after any reconfiguration is B (never worse than the
        static distance).
        """
        if msg_offset % link_offset:
            raise ValueError("unreachable: message offset not multiple of link offset")
        unconstrained = msg_offset // link_offset
        if self.block_size == 1:
            return unconstrained
        if link_offset == 1:
            return msg_offset  # static ring: electrical path, no OCS involved
        return min(msg_offset, unconstrained * self.block_size)

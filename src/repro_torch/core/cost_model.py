"""Topology-aware extended Hockney alpha-beta cost model (paper Section 2).

T(m, A) = sigma(A) * alpha_s
        + sum_k h_k * alpha_h
        + sum_k m_k * c_k * beta
        + R * delta

where, per communication step k:
  alpha_s : per-step startup latency (data preparation), seconds
  alpha_h : per-hop latency (propagation + per-hop processing), seconds
  h_k     : hops to reach the step's destination on the current topology
  m_k     : bytes transmitted in step k
  c_k     : congestion factor (overlapping flows per link)
  beta    : seconds per byte (inverse bandwidth)
  delta   : reconfiguration delay, R: number of reconfigurations

All quantities are SI (seconds, bytes). The model deliberately omits compute
cost (identical across collective algorithms; paper Section 2).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Network cost parameters for one deployment."""

    alpha_s: float = 1.7e-6      # per-step latency [s] (InfiniBand-class, paper 4.1)
    alpha_h: float = 1.0e-6      # per-hop latency [s]
    bandwidth: float = 100e9     # bytes/s (800 Gbps default, paper 4.1)
    delta: float = 10e-6         # reconfiguration delay [s] (RotorNet, Table 2)

    @property
    def beta(self) -> float:
        return 1.0 / self.bandwidth

    def step_cost(self, *, hops: int, nbytes: float, congestion: float) -> float:
        """Cost of a single communication step (no reconfiguration term)."""
        return self.alpha_s + hops * self.alpha_h + nbytes * congestion * self.beta

    def delta_sparse(self, changed_links: int, overlap: float = 0.0) -> float:
        """Effective stall of one *sparse* reconfiguration event.

        Only the ``changed_links`` circuits that actually differ between
        consecutive segments are rewired; the surviving subring links keep
        carrying traffic, and a fraction ``overlap`` of the switching time is
        hidden behind concurrent communication (SWOT-style
        reconfiguration/communication overlap).  Switching is parallel across
        ports, so any change blocks its dependent paths for the residual
        ``delta * (1 - overlap)``; a boundary that changes nothing is free.

        The batch fabric engine (`core.batchsim`) applies the same
        ``delta * (1 - overlap)`` charge per lane with the lane's own delta
        override, which is why it computes the term inline rather than
        through this method.
        """
        if not 0.0 <= overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {overlap}")
        if changed_links <= 0:
            return 0.0
        return self.delta * (1.0 - overlap)

    def total(self, steps: Iterable[tuple[int, float, float]], n_reconfigs: int) -> float:
        """Sum step costs (hops, nbytes, congestion) plus R * delta."""
        t = n_reconfigs * self.delta
        for hops, nbytes, congestion in steps:
            t += self.step_cost(hops=hops, nbytes=nbytes, congestion=congestion)
        return t

    def replace(self, **kw) -> "CostModel":
        return dataclasses.replace(self, **kw)


def gbps(x: float) -> float:
    """Link rate in Gbps -> bytes/s."""
    return x * 1e9 / 8.0


# --- Hardware presets ------------------------------------------------------

#: OCS technologies from paper Table 2: name -> (reconfig time [s], ports)
OCS_TECHNOLOGIES: dict[str, tuple[float, int]] = {
    "sip_lightmatter": (7e-6, 32),
    "rotornet_infocus": (10e-6, 128),
    "3d_mems_calient": (15e-3, 320),
    "piezo_polatis": (25e-3, 576),
}

#: Paper Section 4.1 headline configuration.
PAPER_DEFAULT = CostModel(
    alpha_s=1.7e-6, alpha_h=1.0e-6, bandwidth=gbps(800), delta=10e-6
)

#: One NVIDIA H100 SXM on NVLink 4 behind NVSwitch, used by the port's
#: training driver.  bandwidth: the data sheet's 900 GB/s per GPU in total
#: over both directions, i.e. 450 GB/s each way.  alpha_s, provisional: the
#: time of one one-element shift at offset 1 (`collectives.shift`, NCCL
#: point-to-point) measured by the multi-card phase of `chip_smoke.py` on
#: four H100 80GB HBM3 at 700 W: CUDA events around 200 shifts, median of
#: nine rounds (0.103-0.143 ms a shift), in one run.  The loop is host-bound,
#: so Python and launch overhead are included; PERF.md section 7 says what
#: is still to measure.  alpha_h: 0, since NVSwitch routes every offset in
#: one hop and the measured offset-2 minus offset-1 time (+2.5e-6 s on the
#: events, -3.2e-5 s on the host clock) lies inside the rounds' spread.
#: delta: 0, there is no circuit to reconfigure, so a schedule may change
#: its link offset at every step.
H100_NVLINK = CostModel(
    alpha_s=1.06e-4,
    alpha_h=0.0,
    bandwidth=450e9,
    delta=0.0,
)


def ocs_preset(tech: str, **overrides) -> CostModel:
    """CostModel preset for an OCS technology from paper Table 2."""
    d, _ports = OCS_TECHNOLOGIES[tech]
    cm = PAPER_DEFAULT.replace(delta=d)
    return cm.replace(**overrides) if overrides else cm


def ocs_ports(tech: str) -> int:
    return OCS_TECHNOLOGIES[tech][1]


def sweep(base: CostModel, **axes: Sequence[float]) -> list[CostModel]:
    """Cartesian sweep over cost-model fields, e.g. sweep(cm, delta=[1e-6, 1e-3])."""
    models = [base]
    for field, values in axes.items():
        models = [m.replace(**{field: v}) for m in models for v in values]
    return models

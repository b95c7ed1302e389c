"""Certified fabric playback: the wrapper of the hand-written CUDA kernel B6.

The kernel (`csrc/fabric_playback.cu`) replaces the jitted XLA playback of
the JAX package (`core/batchsim_jax.py:_kernel`), which no `pallas_call`
lies behind.  On a CUDA tensor this wrapper launches it or raises; on a CPU
tensor it runs the plain version `ref.fabric_playback`, which computes the
same function.  There is no fallback from one to the other.  `launches`
counts the calls that launched.

The kernel keeps a lane on chip: its ports' clocks in shared memory, each
slot's chunk train where `launch_plan` puts it (registers, else the CTA's
shared memory, else a workspace in device memory that only its thread
reads), spread over a thread-block cluster of up to 16 CTAs where one SM
cannot hold the lane.  `launch_plan` is the whole of the partition: the
kernel takes its numbers as they are, and
`tests/test_torch_playback_layout.py` plays the partition in NumPy against
the plain version.

The wrapper converts int64 tapes to int32 once, after checking their range
(int32 ones need no check and no host read: the kernel takes any offset g
modulo n, and a step of no or negative hops as one of no hops, as the plain
version does), and `changed` to uint8; the float64 scalars go to the kernel
as doubles.  It orders the lanes longest first on the device (`hops`
summed, no host read), so the longest lane starts first; the kernel writes
each result in lane order.  Every output comes from `torch.empty`; the
kernel writes all of it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import ref

SMEM_LIMIT = 232_448       # dynamic shared memory one CTA may ask for on an H100
MAX_CLUSTER = 16           # CTAs a lane at most: the non-portable cluster size
REG_THREADS = 512          # launch bound of the register kernels: 128 registers a thread
MEM_THREADS = 1024         # launch bound of the memory kernel: 64 registers a thread
# slots a thread of the register kernels, which take C a power of two up to
# 16: 8, 16 or 32 doubles of train a thread
REG_SLOTS = {1: 8, 2: 8, 4: 8, 8: 4, 16: 2}
SCRATCH_BYTES = 8 * (32 + MAX_CLUSTER + 2)   # warp and CTA maxima, two mbarriers
PLACEMENTS = ("registers", "shared", "global")   # where the chunk trains live, in order
# the most ports a lane may have: the double-buffered clocks of 16 CTAs
MAX_PORTS = MAX_CLUSTER * ((SMEM_LIMIT - SCRATCH_BYTES) // 16)


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel lays out one lane: `cluster` CTAs of `threads` threads,
    CTA r owning the slots [r * slots, (r + 1) * slots) of [0, n), thread i
    of a CTA its slots i, i + threads, ... (`spt` of them at most), each
    slot's chunk train in `comp` ("registers", "shared" or "global"),
    `smem_bytes` of dynamic shared memory a CTA."""
    cluster: int
    slots: int
    threads: int
    spt: int
    comp: str
    smem_bytes: int
    regs_estimate: int


def _round32(x: int) -> int:
    return -(-x // 32) * 32


def register_cap(threads: int) -> int:
    """The registers a thread can have when a CTA has `threads` threads and
    the SM's 65,536 are its alone (allocated 8 at a time, at most 255)."""
    return min(255, 65536 // _round32(threads) // 8 * 8)


def _fit(n: int, C: int, cluster: int, comp: str) -> LaunchPlan | None:
    """The plan for (n, C) on `cluster` CTAs with the trains in `comp`, or
    None where they do not fit there."""
    slots = -(-n // cluster)
    if comp == "registers":
        if C not in REG_SLOTS or slots > REG_THREADS * REG_SLOTS[C]:
            return None
        spt = REG_SLOTS[C]
        threads = _round32(-(-slots // spt))
    else:
        threads = min(MEM_THREADS, _round32(slots))
        spt = -(-slots // threads)
    # the most the launch bound lets ptxas give a thread (its own counts are
    # in the build log)
    regs = 65536 // (REG_THREADS if comp == "registers" else MEM_THREADS)
    smem = 16 * slots + SCRATCH_BYTES + (8 * C * slots if comp == "shared" else 0)
    if smem > SMEM_LIMIT:
        return None
    return LaunchPlan(cluster, slots, threads, spt, comp, smem, regs)


def launch_plan(n: int, C: int, *, cluster: int | None = None,
                comp: str | None = None) -> LaunchPlan:
    """The kernel's layout of a lane of n ports and C chunks: the trains in
    registers (C a power of two up to 16) on the fewest CTAs that hold them
    there, else in shared memory on the fewest that hold that, else in
    device memory on as many CTAs as give a thread one slot (at most 16; the
    clocks still on chip).  `cluster` and `comp` force one (the tests' way
    to reach every layout at small n).  Raises ValueError where nothing fits
    (n above MAX_PORTS)."""
    if n < 1 or C < 1:
        raise ValueError(f"n = {n} and C = {C} must be positive")
    if comp is not None and comp not in PLACEMENTS:
        raise ValueError(f"comp must be one of {PLACEMENTS}; got {comp!r}")
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}; got {cluster}")
    for where in (comp,) if comp else PLACEMENTS:
        least = min(MAX_CLUSTER, -(-n // MEM_THREADS)) if where == "global" else 1
        for k in (cluster,) if cluster else range(least, MAX_CLUSTER + 1):
            plan = _fit(n, C, k, where)
            if plan is not None:
                return plan
    raise ValueError(f"no layout of n = {n} ports and C = {C} chunks fits "
                     f"{cluster or MAX_CLUSTER} CTAs (comp {comp or PLACEMENTS}); the "
                     f"kernel takes at most {MAX_PORTS} ports")


def _int32(name: str, t: torch.Tensor) -> torch.Tensor:
    """`t` as contiguous int32: an int64 tensor after checking that its
    values fit (a host read), an int32 one as it is."""
    if t.dtype == torch.int64:
        if t.numel() and (int(t.min()) < -2**31 or int(t.max()) >= 2**31):
            raise ValueError(f"{name} holds values outside int32")
        t = t.to(torch.int32)
    elif t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 or int64; got {t.dtype}")
    return t.contiguous()


_COMP_MODE = {name: i for i, name in enumerate(PLACEMENTS)}


def fabric_playback(nb, g, hops, changed, delta_eff, *, n: int, C: int,
                    alpha_s: float, alpha_h: float, beta: float,
                    _plan: LaunchPlan | None = None):
    """nb: (B, S) float64; g, hops: (B, S) int; changed: (B, S) bool or
    uint8; delta_eff: (B,) float64 -> (node_done (B, n), step_done (B, S),
    port_free (B, n)), float64.  See `ref.fabric_playback`.  `_plan`
    replaces `launch_plan(n, C)` (tests only)."""
    dev = nb.device
    if dev.type == "cpu":
        return ref.fabric_playback(nb, g, hops, changed, delta_eff, n=n, C=C,
                                   alpha_s=alpha_s, alpha_h=alpha_h, beta=beta)
    if dev.type != "cuda" or any(t.device != dev for t in (g, hops, changed, delta_eff)):
        raise ValueError(f"all tapes must share one CUDA device; got {dev}, {g.device}, "
                         f"{hops.device}, {changed.device}, {delta_eff.device}")
    if nb.dim() != 2 or any(t.shape != nb.shape for t in (g, hops, changed)):
        raise ValueError(f"nb {tuple(nb.shape)}, g {tuple(g.shape)}, hops {tuple(hops.shape)} "
                         f"and changed {tuple(changed.shape)} are not one (B, S)")
    bsz, steps = nb.shape
    if delta_eff.shape != (bsz,):
        raise ValueError(f"delta_eff {tuple(delta_eff.shape)} is not (B,) = ({bsz},)")
    if nb.dtype != torch.float64 or delta_eff.dtype != torch.float64:
        raise ValueError(f"nb and delta_eff must be float64; got {nb.dtype}, {delta_eff.dtype}")
    if changed.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"changed must be bool or uint8; got {changed.dtype}")
    if not 1 <= n < 2**31 or not 1 <= C < 2**31:
        raise ValueError(f"n = {n} and C = {C} must be positive int32 values")
    plan = _plan or launch_plan(n, C)
    g, hops = _int32("g", g), _int32("hops", hops)
    changed = changed.to(torch.uint8).contiguous()
    nb, delta_eff = nb.contiguous(), delta_eff.contiguous()
    order = torch.argsort(hops.clamp(min=0).sum(1), descending=True, stable=True).to(torch.int32)

    node_done = torch.empty((bsz, n), dtype=torch.float64, device=dev)
    step_done = torch.empty((bsz, steps), dtype=torch.float64, device=dev)
    port_free = torch.empty((bsz, n), dtype=torch.float64, device=dev)
    comp = (torch.empty(bsz * plan.cluster * C * plan.slots, dtype=torch.float64, device=dev)
            if plan.comp == "global" else None)
    from .._build import library  # builds with nvcc on first use
    err = library().fabric_playback(
        nb.data_ptr(), g.data_ptr(), hops.data_ptr(), changed.data_ptr(), delta_eff.data_ptr(),
        order.data_ptr(), float(alpha_s), float(alpha_h), float(beta), bsz, n, C, steps,
        plan.cluster, plan.slots, plan.threads, plan.spt, _COMP_MODE[plan.comp],
        plan.smem_bytes, node_done.data_ptr(), step_done.data_ptr(),
        port_free.data_ptr(), None if comp is None else comp.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"fabric_playback launch failed: cudaError {err} ({plan})")
    fabric_playback.launches += 1
    return node_done, step_done, port_free


fabric_playback.launches = 0  # calls that launched; never counts a CPU call


def max_active_clusters(plan: LaunchPlan, C: int) -> int:
    """How many of `plan`'s clusters (CTAs at cluster 1) for C chunks the card
    holds at once (`cudaOccupancyMaxActiveClusters`); needs the card."""
    from .._build import library
    out = ctypes.c_int(0)
    err = library().fabric_playback_max_clusters(
        plan.cluster, plan.threads, _COMP_MODE[plan.comp], C, plan.smem_bytes,
        ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {err} ({plan})")
    return out.value

"""Certified fabric playback: the wrapper of the hand-written CUDA kernel B6.

The kernel (`csrc/fabric_playback.cu`) replaces the jitted XLA playback of
the JAX package (`core/batchsim_jax.py:_kernel`), which no `pallas_call`
lies behind.  On a CUDA tensor this wrapper launches it or raises; on a CPU
tensor it runs the plain version `ref.fabric_playback`, which computes the
same function.  There is no fallback from one to the other.  `launches`
counts the calls that launched.

The wrapper converts int64 tapes to int32 once, after checking their range
(int32 ones need no check and no host read: the kernel takes any offset g
modulo n, and a step of no or negative hops as one of no hops, as the plain
version does), and `changed` to uint8; the float64 scalars go to the kernel
as doubles.  Every output and the kernel's double-buffered workspace
(B x 2 x C x n float64) come from `torch.empty`; the kernel zeroes what it
reads first.
"""
from __future__ import annotations

import torch

from . import ref


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


def fabric_playback(nb, g, hops, changed, delta_eff, *, n: int, C: int,
                    alpha_s: float, alpha_h: float, beta: float):
    """nb: (B, S) float64; g, hops: (B, S) int; changed: (B, S) bool or
    uint8; delta_eff: (B,) float64 -> (node_done (B, n), step_done (B, S),
    port_free (B, n)), float64.  See `ref.fabric_playback`."""
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
    g, hops = _int32("g", g), _int32("hops", hops)
    changed = changed.to(torch.uint8).contiguous()
    nb, delta_eff = nb.contiguous(), delta_eff.contiguous()

    node_done = torch.empty((bsz, n), dtype=torch.float64, device=dev)
    step_done = torch.empty((bsz, steps), dtype=torch.float64, device=dev)
    port_free = torch.empty((bsz, n), dtype=torch.float64, device=dev)
    comp = torch.empty((bsz, 2, C, n), dtype=torch.float64, device=dev)
    from .._build import library  # builds with nvcc on first use
    err = library().fabric_playback(
        nb.data_ptr(), g.data_ptr(), hops.data_ptr(), changed.data_ptr(), delta_eff.data_ptr(),
        float(alpha_s), float(alpha_h), float(beta), bsz, n, C, steps, node_done.data_ptr(),
        step_done.data_ptr(), port_free.data_ptr(), comp.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"fabric_playback launch failed: cudaError {err}")
    fabric_playback.launches += 1
    return node_done, step_done, port_free


fabric_playback.launches = 0  # calls that launched; never counts a CPU call

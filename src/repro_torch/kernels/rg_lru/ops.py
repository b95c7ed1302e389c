"""Public RG-LRU op of the port: the CUDA kernels on the card, the plain
versions on the CPU, forward and backward.

The JAX op differentiates its reference scan (`custom_vjp`,
`repro/kernels/rg_lru/ops.py`); here the backward is the kernel B4' on the
card (`kernel.rg_lru_bwd`) and the plain reverse loop on the CPU
(`ref.rg_lru_scan_bwd`), one code path on both devices.  The forward saves
a, b, h0 and its output y, which the kernel reads as h.  Under
`torch.utils.checkpoint` the forward runs again inside the backward; it
keeps no state outside `ctx`.
"""
from __future__ import annotations

import torch

from .kernel import rg_lru_bwd, rg_lru_fwd


class _RgLru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        y, h_last = rg_lru_fwd(a, b, h0)
        ctx.save_for_backward(a, b, h0, y)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh_last):
        a, b, h0, y = ctx.saved_tensors
        gy = torch.zeros_like(y) if gy is None else gy.contiguous()
        da, db, dh0 = rg_lru_bwd(a, b, h0, y, gy, gh_last)
        need = ctx.needs_input_grad
        return (da if need[0] else None, db.to(b.dtype) if need[1] else None,
                dh0.to(h0.dtype) if need[2] else None)


def rg_lru(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, T, D); h0: (B, D) or
    None.  Returns (y in a's dtype, h_last float32)."""
    return _RgLru.apply(a, b, h0)

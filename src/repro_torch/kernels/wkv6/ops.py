"""Public WKV-6 op of the port: the CUDA kernels on the card, the plain
versions on the CPU, forward and backward.

The JAX op differentiates its reference scan (`custom_vjp`,
`repro/kernels/wkv6/ops.py`); here the backward is the kernel B5' on the
card (`kernel.wkv6_bwd`) and the plain reverse loop on the CPU
(`ref.wkv6_scan_bwd`), one code path on both devices.  The forward saves
its inputs and, where the two-pass design writes them (bf16, T > 1), the
states entering each chunk, which the backward recomputes its states from.
Under `torch.utils.checkpoint` the forward runs again inside the backward;
it keeps no state outside `ctx`.
"""
from __future__ import annotations

import torch

from .kernel import wkv6_bwd, wkv6_fwd


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0):
        y, s_last, workspace = wkv6_fwd(r, k, v, log_w, u, s0)
        ctx.save_for_backward(r, k, v, log_w, u, s0, workspace)
        ctx.set_materialize_grads(False)
        return y, s_last

    @staticmethod
    def backward(ctx, gy, gs_last):
        r, k, v, log_w, u, s0, workspace = ctx.saved_tensors
        gy = (torch.zeros(v.shape, dtype=r.dtype, device=r.device) if gy is None
              else gy.contiguous())
        grads = wkv6_bwd(r, k, v, log_w, u, s0, gy, gs_last, workspace)
        inputs = (r, k, v, log_w, u, s0)
        return tuple(g.to(x.dtype) if need else None
                     for g, x, need in zip(grads, inputs, ctx.needs_input_grad, strict=True))


def wkv6(r, k, v, log_w, u, s0=None):
    """RWKV-6 recurrence.  r, k, log_w: (B, H, T, dk); v: (B, H, T, dv); u:
    (H, dk); s0: (B, H, dk, dv) or None.  log_w is the log-space decay (<= 0).
    Returns (y in r's dtype, s_last float32)."""
    return _Wkv6.apply(r, k, v, log_w, u, s0)

"""Plain PyTorch version of the RWKV-6 (Finch) recurrence with data-dependent decay.

Per head (state S in R^{dk x dv}, decay w_t in (0,1)^{dk}, bonus u in R^{dk}):

    y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

A step loop in float32, as `repro/kernels/wkv6/ref.py::wkv6_scan`: it is what
the op runs for a CPU tensor, and what the CUDA kernel is held to.
"""
from __future__ import annotations

import torch


def wkv6_scan(r, k, v, w, u, s0=None):
    """r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0: (B, H, dk, dv)
    or None (zeros).  w is the *decay* in (0, 1), exp(log_w) for a model that
    keeps the decay in log space.

    Returns (y (B, H, T, dv) in r's dtype, s_last (B, H, dk, dv) float32)."""
    bsz, heads, steps, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((bsz, heads, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(steps):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]          # (B,H,dk,dv)
        att = s + uf * kv                                          # S_{t-1} + (u*k)v^T
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], att))
        s = wf[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2).to(r.dtype), s

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


def wkv6_scan_bwd(r, k, v, log_w, u, s0, gy, gs_last=None):
    """The gradients of the recurrence with the decay w = exp(log_w): a
    reverse loop in float32 (float64 for float64 inputs).

    gy: (B, H, T, dv), the cotangent of y; gs_last: (B, H, dk, dv) or None
    (zeros), that of s_last.  With G_t the gradient of S_t (G_{T-1} =
    gs_last), for t = T-1 .. 0:
        dr_t[i] = sum_j gy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
        dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . gy_t)
        dv_t[j] = sum_i G_t[i,j] k_t[i] + gy_t[j] sum_i u_i r_t[i] k_t[i]
        dlog_w_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
        du[i] += r_t[i] k_t[i] (v_t . gy_t)        (over batch and time)
        G_{t-1} = diag(w_t) G_t + r_t gy_t^T
    and ds0 = G_{-1}.  The states S_{t-1} are recomputed forward first.
    Returns (dr, dk, dv, dlog_w, du, ds0), each in its input's dtype (ds0
    in the loop's dtype without s0)."""
    bsz, heads, steps, dk = r.shape
    dv = v.shape[-1]
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, gyf = (x.to(acc) for x in (r, k, v, gy))
    wf = torch.exp(log_w.to(acc))
    uf = u.to(acc)[None]                                           # (1, H, dk)
    s = (torch.zeros((bsz, heads, dk, dv), dtype=acc, device=r.device)
         if s0 is None else s0.to(acc))
    states = []                                                    # S_{t-1}
    for t in range(steps):
        states.append(s)
        s = wf[:, :, t, :, None] * s + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    g = (torch.zeros((bsz, heads, dk, dv), dtype=acc, device=r.device)
         if gs_last is None else gs_last.to(acc))
    d_r, d_k, d_lw = (torch.empty((bsz, heads, steps, dk), dtype=acc, device=r.device)
                      for _ in range(3))
    d_v = torch.empty((bsz, heads, steps, dv), dtype=acc, device=r.device)
    d_u = torch.zeros(uf.shape[1:], dtype=acc, device=r.device)
    for t in range(steps - 1, -1, -1):
        rt, kt, vt, wt, gt, sp = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t], \
            gyf[:, :, t], states[t]
        vg = (vt * gt).sum(-1, keepdim=True)                       # v_t . gy_t
        d_r[:, :, t] = torch.einsum("bhkv,bhv->bhk", sp, gt) + uf * kt * vg
        d_k[:, :, t] = torch.einsum("bhkv,bhv->bhk", g, vt) + uf * rt * vg
        d_v[:, :, t] = torch.einsum("bhkv,bhk->bhv", g, kt) \
            + gt * (uf * rt * kt).sum(-1, keepdim=True)
        d_lw[:, :, t] = wt * (g * sp).sum(-1)
        d_u += (rt * kt * vg).sum(0)
        g = wt[..., None] * g + rt[..., None] * gt[:, :, None, :]
    return (d_r.to(r.dtype), d_k.to(k.dtype), d_v.to(v.dtype), d_lw.to(log_w.dtype),
            d_u.to(u.dtype), g if s0 is None else g.to(s0.dtype))

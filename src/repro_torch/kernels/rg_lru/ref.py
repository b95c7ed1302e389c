"""Plain PyTorch version of the RG-LRU gated linear recurrence (Griffin).

    h_t = a_t * h_{t-1} + b_t        (elementwise over the model dimension)

A step loop in float32, as `repro/kernels/rg_lru/ref.py::rg_lru_scan`: it is
what the op runs for a CPU tensor, and what the CUDA kernel is held to.
"""
from __future__ import annotations

import torch


def rg_lru_scan(a, b, h0=None):
    """a, b: (B, T, D); h0: (B, D) or None (zeros).  Returns (y, h_last):
    y[:, t] = h_t in a's dtype, h_last (B, D) float32."""
    bsz, steps, d = a.shape
    h = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    af, bf = a.float(), b.float()
    ys = []
    for t in range(steps):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(a.dtype), h


def rg_lru_scan_bwd(a, b, h0, gy, gh_last=None):
    """The gradients of `rg_lru_scan`: a reverse loop in float32.

    gy: (B, T, D), the cotangent of y; gh_last: (B, D) or None (zeros), that
    of h_last.  With dh_t the gradient of h_t,
        dh_{T-1} = gy_{T-1} + gh_last,   dh_t = gy_t + a_{t+1} dh_{t+1},
        da_t = dh_t h_{t-1} (h_{-1} = h0, or 0),   db_t = dh_t,   dh0 = a_0 dh_0.
    h is recomputed forward first.  Returns (da, db, dh0): da and db in a's
    and b's dtypes, dh0 (B, D) in h0's dtype (float32 without h0)."""
    bsz, steps, d = a.shape
    h = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    af, bf, gyf = a.float(), b.float(), gy.float()
    hs = [h]                                  # hs[t] = h_{t-1}
    for t in range(steps - 1):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    dh = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device) if gh_last is None
          else gh_last.float())
    da = torch.empty((bsz, steps, d), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    for t in range(steps - 1, -1, -1):
        dh = dh + gyf[:, t]
        db[:, t] = dh
        da[:, t] = dh * hs[t]
        dh = af[:, t] * dh
    return da.to(a.dtype), db.to(b.dtype), dh if h0 is None else dh.to(h0.dtype)

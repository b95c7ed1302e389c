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

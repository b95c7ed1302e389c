"""Public WKV-6 op of the port: the CUDA kernel on the card, the plain
version on the CPU.

The JAX op differentiates the reference scan (`custom_vjp`); the port has no
backward kernel yet.  On the CPU the plain version is differentiable by
autograd; on the card a call that needs a gradient raises rather than take a
plain path.
"""
from __future__ import annotations

import torch

from .kernel import wkv6_fwd


def wkv6(r, k, v, log_w, u, s0=None):
    """RWKV-6 recurrence.  r, k, log_w: (B, H, T, dk); v: (B, H, T, dv); u:
    (H, dk); s0: (B, H, dk, dv) or None.  log_w is the log-space decay (<= 0).
    Returns (y in r's dtype, s_last float32)."""
    if r.device.type != "cpu" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, log_w, u, s0)):
        raise NotImplementedError(
            "wkv6 has no backward on the card yet: ROADMAP A14 (training the "
            "recurrent archs)")
    return wkv6_fwd(r, k, v, log_w, u, s0)

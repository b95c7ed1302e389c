"""Public RG-LRU op of the port: the CUDA kernel on the card, the plain
version on the CPU.

The JAX op differentiates the reference scan (`custom_vjp`); the port has no
backward kernel yet.  On the CPU the plain version is differentiable by
autograd; on the card a call that needs a gradient raises rather than take a
plain path.
"""
from __future__ import annotations

import torch

from .kernel import rg_lru_fwd


def rg_lru(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, T, D); h0: (B, D) or
    None.  Returns (y in a's dtype, h_last float32)."""
    if a.device.type != "cpu" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        raise NotImplementedError(
            "rg_lru has no backward on the card yet: ROADMAP A14 (training the "
            "recurrent archs)")
    return rg_lru_fwd(a, b, h0)

"""Public flash-attention op of the port (forward only in this slice).

`flash_attention` runs the CUDA kernel for CUDA tensors and the plain version
for CPU tensors (see kernel.py).  The backward kernels (dK/dV and dQ) belong
to the training slice; until then differentiating through this op raises
instead of quietly going through the plain version.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_fwd_lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, _lse = flash_attention_fwd_lse(q, k, v, scale=scale, causal=causal,
                                            window=window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward (dK/dV and dQ kernels) is not ported yet: "
            "it comes with the training slice (ROADMAP queue A, training)")


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int = 512,
                    block_k: int = 512):
    """Attention with online softmax.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hkv | Hq.  Returns (B, Hq, Sq, D).
    `block_q`/`block_k` are kept for signature parity; the kernel picks its
    own tiles.
    """
    del block_q, block_k
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, causal, window, scale)

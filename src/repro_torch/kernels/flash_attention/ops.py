"""Public flash-attention op of the port: CUDA forward + CUDA backward.

`flash_attention` runs the CUDA kernels for CUDA tensors and their plain
versions for CPU tensors (see kernel.py, kernel_bwd.py).  The forward saves
q, k, v, the output and the logsumexp; the backward expands K/V to the query
heads, runs the dK/dV and dQ kernels from the saved logsumexp, and sums dK/dV
over each GQA group, as `repro/kernels/flash_attention/ops.py` does.  Under
`torch.utils.checkpoint` the forward runs again inside the backward; it keeps
no state outside `ctx`.

A value head narrower than the query head (MLA: q/k heads of nope + rope,
value heads of v_head_dim) is zero-padded up to the query head before the
kernels and the output sliced back after; that is exact, since the padded
columns of P.V are zero, and autograd carries the gradient through both.
A query head between the kernels' head dims (`kernel.HEAD_DIMS`; the
scaled-down MLA's 16 + 8 = 24) pads q and k alike up to the next one, the
scale staying the unpadded head's: the padded columns add nothing to QK^T.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import HEAD_DIMS, flash_attention_fwd_lse
from .kernel_bwd import flash_attention_bwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_fwd_lse(q, k, v, scale=scale, causal=causal,
                                           window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        b, hkv, sk, d = k.shape
        group = q.shape[1] // hkv
        k_full = k.repeat_interleave(group, dim=1) if group > 1 else k
        v_full = v.repeat_interleave(group, dim=1) if group > 1 else v
        dq, dk, dv = flash_attention_bwd(
            q, k_full, v_full, out, lse, grad_out.contiguous(), scale=ctx.scale,
            causal=ctx.causal, window=ctx.window)
        if group > 1:  # GQA: sum gradients over the query-head group
            dk = dk.reshape(b, hkv, group, sk, d).sum(dim=2)
            dv = dv.reshape(b, hkv, group, sk, d).sum(dim=2)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int = 512,
                    block_k: int = 512):
    """Attention with online softmax.

    q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D), Hkv | Hq; v: (B, Hkv, Sk, Dv),
    Dv <= D.  Returns (B, Hq, Sq, Dv).  `block_q`/`block_k` are kept for
    signature parity; the kernels pick their own tiles.
    """
    del block_q, block_k
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    d, dv = q.shape[-1], v.shape[-1]
    if dv > d:
        raise ValueError(f"value head {dv} wider than the query head {d}")
    head = padded_head(d)
    if head != d:
        q, k = F.pad(q, (0, head - d)), F.pad(k, (0, head - d))
    if dv < head:
        out = _FlashAttention.apply(q, k, F.pad(v, (0, head - dv)), causal, window, scale)
        return out[..., :dv]
    return _FlashAttention.apply(q, k, v, causal, window, scale)


def padded_head(d: int) -> int:
    """The kernels' head dim that a query head of `d` runs at: the smallest
    of `HEAD_DIMS` that holds it (`d` itself past the largest, which the
    kernels refuse)."""
    return min((h for h in HEAD_DIMS if h >= d), default=d)

"""Plain PyTorch versions of flash attention (causal / sliding-window / bidir, GQA).

`attention_mask` and `attention` mirror the JAX oracle (`-inf` masking, NaN on
a row with no live key).  `attention_fwd_lse` reproduces what the TPU kernel
and the CUDA kernel compute, and is what a wrapper runs for a CPU tensor:
masked scores are filled with the finite `NEG_INF`, the denominator is
clamped at 1e-30, and the f32 logsumexp comes back beside the output.

`attention_bwd` (with its two halves `attention_bwd_dkv` and
`attention_bwd_dq`) is the plain version of the backward kernels, in the MHA
layout they take, following the formulas of the TPU kernels
(`repro/kernels/flash_attention/kernel_bwd.py`): P = exp(s scale - lse),
zero where masked; D = rowsum(dO o O); dV = P^T dO;
dS = P o (dO V^T - D) scale; dQ = dS K; dK = dS^T Q.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, causal: bool, window: int | None,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """(sq, sk) boolean mask. Query i attends key j iff:
       causal: j <= i + (sk - sq)   (offset aligns last query to last key)
       window: i + off - window < j (sliding window of `window` keys, incl. self)
    """
    off = sk - sq
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi + off
    if window is not None:
        mask &= kj > qi + off - window
    return mask


def _scores(q, k, scale):
    """f32 scaled scores (B, Hq, Sq, Sk) with K expanded to the query heads."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"kv heads {hkv} do not divide query heads {hq}")
    k = k.repeat_interleave(hq // hkv, dim=1)
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hkv divides Hq (GQA).

    Returns (B, Hq, Sq, D). float32 accumulation regardless of input dtype.
    """
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = _scores(q, k, scale)
    mask = attention_mask(sq, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_fwd_lse(q, k, v, *, scale: float, causal: bool,
                      window: int | None):
    """The kernel's function: (out in q's dtype, lse f32 (B, Hq, Sq)).

    Rows with no live key (possible only when Sq > Sk) are not specified:
    here they average V, the kernels may return zeros.
    """
    sq, sk = q.shape[2], k.shape[2]
    s = _scores(q, k, scale)
    mask = attention_mask(sq, sk, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, lse, do, dvec, scale, causal, window):
    """f32 P and dS (B, H, Sq, Sk) of the MHA backward; P is 0 where masked."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"the backward takes MHA: {q.shape[1]} query heads, "
                         f"{k.shape[1]} kv heads")
    sq, sk = q.shape[2], k.shape[2]
    s = _scores(q, k, scale)
    mask = attention_mask(sq, sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - dvec[..., None]) * scale
    return p, ds


def attention_bwd_dkv(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                      window: int | None):
    """Plain version of the dK/dV kernel: (dk, dv) in q's dtype."""
    p, ds = _bwd_probs(q, k, v, lse, do, dvec, scale, causal, window)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_dq(q, k, v, do, lse, dvec, *, scale: float, causal: bool,
                     window: int | None):
    """Plain version of the dQ kernel: dq in q's dtype."""
    _, ds = _bwd_probs(q, k, v, lse, do, dvec, scale, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool,
                  window: int | None):
    """MHA backward from the forward's (o, lse): (dq, dk, dv) in q's dtype.

    q, o, do: (B, H, Sq, D); k, v: (B, H, Sk, D); lse: (B, H, Sq) f32.
    """
    dvec = (do.float() * o.float()).sum(-1)
    kw = {"scale": scale, "causal": causal, "window": window}
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    return attention_bwd_dq(q, k, v, do, lse, dvec, **kw), dk, dv

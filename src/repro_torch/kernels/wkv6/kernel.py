"""RWKV-6 forward: the wrapper of the hand-written CUDA kernel.

The kernel (`csrc/wkv6.cu`) replaces the TPU kernel `_wkv6_kernel` of the
JAX package.  On a CUDA tensor this wrapper launches it or raises; on a CPU
tensor it runs the plain version `ref.wkv6_scan` on exp(log_w), which
computes the same function.  There is no fallback from one to the other.

The TPU version padded T to its 64-step blocks with log_w = 0, k = 0; the
CUDA kernel bounds its last chunk instead, so nothing is padded.
"""
from __future__ import annotations

import torch

from . import ref

MAX_DIM = 64   # dk, dv the kernel takes: 1 .. 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def wkv6_fwd(r, k, v, log_w, u, s0=None):
    """r, k, log_w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0:
    (B, H, dk, dv) or None (zeros).  log_w is the log-space decay (<= 0).

    Returns (y (B, H, T, dv) in r's dtype, s_last (B, H, dk, dv) float32).
    """
    if r.device.type == "cpu":
        return ref.wkv6_scan(r, k, v, torch.exp(log_w.float()), u, s0)
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError(f"r, k, v, log_w, u, s0 must share one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, log_w)):
        raise ValueError(f"dtypes of r, k, v, log_w must all be float32 or bfloat16; got "
                         f"{[t.dtype for t in (r, k, v, log_w)]}")
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape \
            or v.shape[:3] != r.shape[:3] or v.dim() != 4:
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, log_w {tuple(log_w.shape)} do not fit "
                         f"(B,H,T,dk)/(B,H,T,dv)")
    bsz, heads, steps, dk = r.shape
    dv = v.shape[-1]
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"dk {dk}, dv {dv}: the kernel takes 1 .. {MAX_DIM}")
    if min(bsz, heads, steps) == 0:
        raise ValueError("empty batch, head or time dimension")
    if tuple(u.shape) != (heads, dk):
        raise ValueError(f"u {tuple(u.shape)} is not (H, dk) = {(heads, dk)}")
    if s0 is not None and tuple(s0.shape) != (bsz, heads, dk, dv):
        raise ValueError(f"s0 {tuple(s0.shape)} is not (B, H, dk, dv) = "
                         f"{(bsz, heads, dk, dv)}")
    if not all(t.is_contiguous() for t in (r, k, v, log_w)):
        raise ValueError("r, k, v, log_w must be contiguous")
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()

    from .._build import library  # builds with nvcc on first use

    lib = library()
    y = torch.empty((bsz, heads, steps, dv), dtype=r.dtype, device=r.device)
    s_last = torch.empty((bsz, heads, dk, dv), dtype=torch.float32, device=r.device)
    err = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                       u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
                       s_last.data_ptr(), bsz * heads, heads, steps, dk, dv,
                       _DTYPES[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_fwd launch failed: cudaError {err}")
    wkv6_fwd.launches += 1
    return y, s_last


wkv6_fwd.launches = 0   # kernel launches; never counts a CPU call

"""RG-LRU forward: the wrapper of the hand-written CUDA kernel.

The kernel (`csrc/rg_lru.cu`) replaces the TPU kernel `_rg_lru_kernel` of the
JAX package.  On a CUDA tensor this wrapper launches it or raises; on a CPU
tensor it runs the plain version `ref.rg_lru_scan`, which computes the same
function.  There is no fallback from one to the other.

The TPU version padded T and D to its blocks with a = 1, b = 0; the CUDA
kernel bounds its loops instead, so nothing is padded.
"""
from __future__ import annotations

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rg_lru_fwd(a, b, h0=None):
    """a, b: (B, T, D); h0: (B, D) or None (zeros) -> (y, h_last).

    y: (B, T, D) in a's dtype, y[:, t] = h_t; h_last: (B, D) float32.
    """
    if a.device.type == "cpu":
        return ref.rg_lru_scan(a, b, h0)
    if a.device.type != "cuda" or b.device != a.device or (
            h0 is not None and h0.device != a.device):
        raise ValueError(f"a, b and h0 must share one CUDA device; got {a.device}, "
                         f"{b.device}, {None if h0 is None else h0.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"dtypes must both be float32 or bfloat16; got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)} are not one (B, T, D)")
    bsz, steps, d = a.shape
    if min(bsz, steps, d) == 0:
        raise ValueError("empty batch, time or feature dimension")
    if h0 is not None and tuple(h0.shape) != (bsz, d):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B, D) = {(bsz, d)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if h0 is not None:
        h0 = h0.float().contiguous()

    from .._build import library  # builds with nvcc on first use

    lib = library()
    y = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
    err = lib.rg_lru_fwd(a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
                         y.data_ptr(), h_last.data_ptr(), bsz, steps, d, _DTYPES[a.dtype],
                         torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rg_lru_fwd launch failed: cudaError {err}")
    rg_lru_fwd.launches += 1
    return y, h_last


rg_lru_fwd.launches = 0   # kernel launches; never counts a CPU call

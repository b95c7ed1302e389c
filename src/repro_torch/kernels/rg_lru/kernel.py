"""RG-LRU forward: the wrapper of the hand-written CUDA kernels.

The kernels (`csrc/rg_lru.cu`) replace the TPU kernel `_rg_lru_kernel` of the
JAX package.  On a CUDA tensor this wrapper launches them or raises; on a CPU
tensor it runs the plain version `ref.rg_lru_scan`, which computes the same
function.  There is no fallback from one to the other.

Two kernels, chosen by T: T = 1 (a decode step) the step kernel, T > 1 the
ring design (a CTA a 128-byte column of lanes, the loads of later steps in
flight while the chain runs).  `launches` counts every call that launches,
`launches_step` the T = 1 ones.

The TPU version padded T and D to its blocks with a = 1, b = 0; the CUDA
kernels bound their loops instead, so nothing is padded.

The wrapper's host work is what a decode call costs beyond its few
microseconds of device time, so the bound C function is looked up once, the
current stream is read without building a Stream object and h0 is converted
only when it is not f32 and contiguous already; every check of device,
dtype, shape and contiguity stays.
"""
from __future__ import annotations

import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None  # the library's rg_lru_fwd, bound on the first launch


def _rg_lru_launcher():
    global _launcher
    if _launcher is None:
        from .._build import library  # builds with nvcc on first use
        _launcher = library().rg_lru_fwd
    return _launcher


def _check(a, b, h0):
    """Raises ValueError on what the kernels do not take (a, b not on the CPU)."""
    dev = a.device
    if dev.type != "cuda" or b.device != dev or (h0 is not None and h0.device != dev):
        raise ValueError(f"a, b and h0 must share one CUDA device; got {dev}, "
                         f"{b.device}, {None if h0 is None else h0.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"dtypes must both be float32 or bfloat16; got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)} are not one (B, T, D)")
    bsz, steps, d = a.shape
    if min(bsz, steps, d) == 0:
        raise ValueError("empty batch, time or feature dimension")
    if h0 is not None and h0.shape != (bsz, d):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B, D) = {(bsz, d)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def rg_lru_fwd(a, b, h0=None):
    """a, b: (B, T, D); h0: (B, D) or None (zeros) -> (y, h_last).

    y: (B, T, D) in a's dtype, y[:, t] = h_t; h_last: (B, D) float32.
    """
    dev = a.device
    if dev.type == "cpu":
        return ref.rg_lru_scan(a, b, h0)
    _check(a, b, h0)
    bsz, steps, d = a.shape
    if h0 is not None and (h0.dtype != torch.float32 or not h0.is_contiguous()):
        h0 = h0.float().contiguous()

    launch = _rg_lru_launcher()
    y = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    err = launch(a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), bsz, steps, d, _DTYPES[a.dtype],
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"rg_lru_fwd launch failed: cudaError {err}")
    rg_lru_fwd.launches += 1
    rg_lru_fwd.launches_step += steps == 1
    return y, h_last


rg_lru_fwd.launches = 0       # calls that launched; never counts a CPU call
rg_lru_fwd.launches_step = 0  # of which the T = 1 kernel

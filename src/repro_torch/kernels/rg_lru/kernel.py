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

`rg_lru_bwd` wraps the backward kernel (B4', the same file): the ring
walked from the end of T to 0, reading the forward's y as h; on a CPU
tensor it runs the plain `ref.rg_lru_scan_bwd`.  Its `launches` counts its
calls that launch.

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


def rg_lru_bwd(a, b, h0, y, gy, gh_last=None):
    """The gradients of `rg_lru_fwd(a, b, h0) = (y, h_last)`.  y: the forward's
    output, which the kernel reads as h (in bf16, h rounded); gy: (B, T, D)
    in a's dtype, the cotangent of y; gh_last: (B, D) or None (zeros), that
    of h_last.

    Returns (da, db in a's dtype, dh0 (B, D) float32; on a CPU tensor the
    plain version's, dh0 in h0's dtype)."""
    dev = a.device
    if dev.type == "cpu":
        return ref.rg_lru_scan_bwd(a, b, h0, gy, gh_last)
    _check(a, b, h0)
    bsz, _, d = a.shape
    for name, t in (("y", y), ("gy", gy)):
        if t.device != dev or t.dtype != a.dtype or t.shape != a.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(a.shape)} {a.dtype} tensor "
                             f"on {dev}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if gh_last is not None and (gh_last.device != dev or gh_last.shape != (bsz, d)):
        raise ValueError(f"gh_last {tuple(gh_last.shape)} on {gh_last.device} is not (B, D) = "
                         f"{(bsz, d)} on {dev}")
    h0, gh_last = (None if t is None else t.float().contiguous() for t in (h0, gh_last))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    from .._build import library
    err = library().rg_lru_bwd(
        a.data_ptr(), y.data_ptr(), None if h0 is None else h0.data_ptr(), gy.data_ptr(),
        None if gh_last is None else gh_last.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), bsz, a.shape[1], d, _DTYPES[a.dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"rg_lru_bwd launch failed: cudaError {err}")
    rg_lru_bwd.launches += 1
    return da, db, dh0


rg_lru_bwd.launches = 0  # calls that launched; never counts a CPU call

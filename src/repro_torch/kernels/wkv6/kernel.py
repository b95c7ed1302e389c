"""RWKV-6 forward: the wrapper of the hand-written CUDA kernels.

The kernels (`csrc/wkv6.cu`) replace the TPU kernel `_wkv6_kernel` of the
JAX package.  On a CUDA tensor this wrapper launches them or raises; on a CPU
tensor it runs the plain version `ref.wkv6_scan` on exp(log_w), which
computes the same function.  There is no fallback from one to the other.

Three kernels, chosen by T and the inputs' dtype:
  T = 1 (a decode step), either dtype: the step kernel, in f32;
  bf16, T > 1: two passes, a state pass (the state entering each 64-step
    chunk into a workspace this wrapper allocates; k e^{c_last - c} enters
    its product as two TF32 parts, ~21 bits) and an output pass (y from
    that state, its products in TF32: the derived operands are rounded to
    TF32, the one numerical difference from the plain version);
  f32, T > 1: the first design, one CTA per (batch, head), all in f32.
`launches` counts every call that launches (one or two kernels),
`launches_chunked` the two-pass ones and `launches_step` the T = 1 ones.

The TPU version padded T to its 64-step blocks with log_w = 0, k = 0; the
CUDA kernels bound their last chunk instead, so nothing is padded.

The wrapper's host work is what a decode call costs beyond its few
microseconds of device time, so the bound C function is looked up once and
the current stream is read without building a Stream object; every check of
device, dtype, shape and contiguity stays.
"""
from __future__ import annotations

import torch

from . import ref

MAX_DIM = 64   # dk, dv the kernel takes: 1 .. 64
CHUNK = 64     # steps per chunk of the two-pass design
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None  # the library's wkv6_fwd, bound on the first launch


def _wkv6_launcher():
    global _launcher
    if _launcher is None:
        from .._build import library  # builds with nvcc on first use
        _launcher = library().wkv6_fwd
    return _launcher


def wkv6_fwd(r, k, v, log_w, u, s0=None):
    """r, k, log_w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0:
    (B, H, dk, dv) or None (zeros).  log_w is the log-space decay (<= 0).

    Returns (y (B, H, T, dv) in r's dtype, s_last (B, H, dk, dv) float32).
    """
    dev = r.device
    if dev.type == "cpu":
        return ref.wkv6_scan(r, k, v, torch.exp(log_w.float()), u, s0)
    if dev.type != "cuda" or k.device != dev or v.device != dev or log_w.device != dev \
            or u.device != dev or (s0 is not None and s0.device != dev):
        tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
        raise ValueError(f"r, k, v, log_w, u, s0 must share one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    dtype = r.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype or log_w.dtype != dtype:
        raise ValueError(f"dtypes of r, k, v, log_w must all be float32 or bfloat16; got "
                         f"{[t.dtype for t in (r, k, v, log_w)]}")
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or log_w.shape != shape \
            or v.dim() != 4 or v.shape[:3] != shape[:3]:
        raise ValueError(f"shapes r {tuple(shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, log_w {tuple(log_w.shape)} do not fit "
                         f"(B,H,T,dk)/(B,H,T,dv)")
    bsz, heads, steps, dk = shape
    dv = v.shape[3]
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"dk {dk}, dv {dv}: the kernel takes 1 .. {MAX_DIM}")
    if bsz == 0 or heads == 0 or steps == 0:
        raise ValueError("empty batch, head or time dimension")
    if u.shape != (heads, dk):
        raise ValueError(f"u {tuple(u.shape)} is not (H, dk) = {(heads, dk)}")
    if s0 is not None and s0.shape != (bsz, heads, dk, dv):
        raise ValueError(f"s0 {tuple(s0.shape)} is not (B, H, dk, dv) = "
                         f"{(bsz, heads, dk, dv)}")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and log_w.is_contiguous()):
        raise ValueError("r, k, v, log_w must be contiguous")
    if u.dtype != torch.float32 or not u.is_contiguous():
        u = u.float().contiguous()
    if s0 is not None and (s0.dtype != torch.float32 or not s0.is_contiguous()):
        s0 = s0.float().contiguous()

    launch = _wkv6_launcher()
    y = torch.empty((bsz, heads, steps, dv), dtype=dtype, device=dev)
    s_last = torch.empty((bsz, heads, dk, dv), dtype=torch.float32, device=dev)
    chunked = steps > 1 and dtype == torch.bfloat16
    workspace = torch.empty((bsz * heads, -(-steps // CHUNK), MAX_DIM, MAX_DIM),
                            dtype=torch.float32, device=dev) if chunked else None
    err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
                 None if workspace is None else workspace.data_ptr(), bsz * heads, heads,
                 steps, dk, dv, _DTYPES[dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"wkv6_fwd launch failed: cudaError {err}")
    wkv6_fwd.launches += 1
    wkv6_fwd.launches_chunked += chunked
    wkv6_fwd.launches_step += steps == 1
    return y, s_last


wkv6_fwd.launches = 0          # calls that launched; never counts a CPU call
wkv6_fwd.launches_chunked = 0  # of which the two-pass design (bf16, T > 1)
wkv6_fwd.launches_step = 0     # of which the T = 1 kernel

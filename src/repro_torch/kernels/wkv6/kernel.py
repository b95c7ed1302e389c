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

`wkv6_bwd` wraps the backward (B5', `csrc/wkv6_bwd.cu`), which starts
from the states entering each chunk (the two-pass forward's workspace,
rounded to TF32, which `wkv6_fwd` returns as its third result; else the
backward walks them forward first, in f32).  Two designs, chosen by dtype:
  bf16: the chunked form on the tensor cores, two passes: the gradient of
    the state leaving each chunk, walked from the last chunk to the first
    into a second workspace this wrapper allocates, then one CTA a chunk
    for dr, dk, dv, dlog_w and a du partial, summed in a fixed order;
  f32: the first design, a reverse walk over row blocks of the state, then
    a fixed-order sum of dv and du.
On a CPU tensor it runs the plain `ref.wkv6_scan_bwd`.  Its `launches`
counts its calls that launch, `launches_chunked` the bf16 ones and
`launches_entry` those that had to walk the chunk-entry states first.

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
ROWS = 16      # rows of the state a CTA of the backward takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None  # the library's wkv6_fwd, bound on the first launch


def _wkv6_launcher():
    global _launcher
    if _launcher is None:
        from .._build import library  # builds with nvcc on first use
        _launcher = library().wkv6_fwd
    return _launcher


def _check(r, k, v, log_w, u, s0):
    """Raises ValueError on what the kernels do not take (r not on the CPU)."""
    dev = r.device
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


def wkv6_fwd(r, k, v, log_w, u, s0=None):
    """r, k, log_w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0:
    (B, H, dk, dv) or None (zeros).  log_w is the log-space decay (<= 0).

    Returns (y (B, H, T, dv) in r's dtype, s_last (B, H, dk, dv) float32,
    workspace): the workspace holds the state entering each chunk,
    (B*H, ceil(T / 64), 64, 64) float32, where the design writes it (bf16,
    T > 1), and is None elsewhere.
    """
    dev = r.device
    if dev.type == "cpu":
        return (*ref.wkv6_scan(r, k, v, torch.exp(log_w.float()), u, s0), None)
    _check(r, k, v, log_w, u, s0)
    bsz, heads, steps, dk = r.shape
    dtype, dv = r.dtype, v.shape[3]
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
    return y, s_last, workspace


wkv6_fwd.launches = 0          # calls that launched; never counts a CPU call
wkv6_fwd.launches_chunked = 0  # of which the two-pass design (bf16, T > 1)
wkv6_fwd.launches_step = 0     # of which the T = 1 kernel


def wkv6_bwd(r, k, v, log_w, u, s0, gy, gs_last=None, workspace=None):
    """The gradients of (y, s_last) = `wkv6_fwd(r, k, v, log_w, u, s0)[:2]`.  gy:
    (B, H, T, dv) in r's dtype, the cotangent of y; gs_last: (B, H, dk, dv)
    or None (zeros), that of s_last; workspace: the forward's chunk-entry
    states (its third result), or None.

    Returns (dr, dk, dv, dlog_w in r's dtype, du (H, dk) float32, ds0
    (B, H, dk, dv) float32; on a CPU tensor the plain version's, du in u's
    dtype and ds0 in s0's)."""
    dev = r.device
    if dev.type == "cpu":
        return ref.wkv6_scan_bwd(r, k, v, log_w, u, s0, gy, gs_last)
    _check(r, k, v, log_w, u, s0)
    bsz, heads, steps, dk = r.shape
    dv = v.shape[3]
    if gy.device != dev or gy.dtype != r.dtype or gy.shape != v.shape or not gy.is_contiguous():
        raise ValueError(f"gy must be a contiguous {tuple(v.shape)} {r.dtype} tensor on {dev}; "
                         f"got {tuple(gy.shape)} {gy.dtype} on {gy.device}")
    if gs_last is not None and (gs_last.device != dev or gs_last.shape != (bsz, heads, dk, dv)):
        raise ValueError(f"gs_last {tuple(gs_last.shape)} on {gs_last.device} is not "
                         f"(B, H, dk, dv) = {(bsz, heads, dk, dv)} on {dev}")
    n_chunks = -(-steps // CHUNK)
    if workspace is not None and (workspace.device != dev or workspace.dtype != torch.float32
                                  or workspace.shape != (bsz * heads, n_chunks, MAX_DIM, MAX_DIM)
                                  or not workspace.is_contiguous()):
        raise ValueError(f"workspace {tuple(workspace.shape)} {workspace.dtype} is not the "
                         f"forward's ({bsz * heads}, {n_chunks}, {MAX_DIM}, {MAX_DIM}) float32")
    u = u.float().contiguous()
    s0, gs_last = (None if t is None else t.float().contiguous() for t in (s0, gs_last))
    have_states = workspace is not None
    state_shape = (bsz * heads, n_chunks, MAX_DIM, MAX_DIM)
    if not have_states:  # zeros: the entry pass writes only the rows of dk's row blocks
        workspace = torch.zeros(state_shape, dtype=torch.float32, device=dev)
    d_r, d_k, d_lw = (torch.empty_like(r) for _ in range(3))
    d_v = torch.empty_like(v)
    d_u = torch.empty((heads, dk), dtype=torch.float32, device=dev)
    ds0 = torch.empty((bsz, heads, dk, dv), dtype=torch.float32, device=dev)
    chunked = r.dtype == torch.bfloat16
    if chunked:  # the gradient entering each chunk's end, one du partial a chunk
        dv_part = None
        g_states = torch.empty(state_shape, dtype=torch.float32, device=dev)
        du_part = torch.empty((bsz * heads, n_chunks, MAX_DIM), dtype=torch.float32, device=dev)
    else:
        dv_part = torch.empty((bsz * heads, -(-dk // ROWS), steps, MAX_DIM), dtype=torch.float32,
                              device=dev)
        g_states = None
        du_part = torch.empty((bsz, heads, dk), dtype=torch.float32, device=dev)
    from .._build import library
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = library().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(), ptr(s0),
        gy.data_ptr(), ptr(gs_last), workspace.data_ptr(), int(have_states), d_r.data_ptr(),
        d_k.data_ptr(), d_v.data_ptr(), d_lw.data_ptr(), d_u.data_ptr(), ds0.data_ptr(),
        ptr(dv_part), ptr(g_states), du_part.data_ptr(), bsz, heads, steps, dk, dv,
        _DTYPES[r.dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"wkv6_bwd launch failed: cudaError {err}")
    wkv6_bwd.launches += 1
    wkv6_bwd.launches_chunked += chunked
    wkv6_bwd.launches_entry += not have_states
    return d_r, d_k, d_v, d_lw, d_u, ds0


wkv6_bwd.launches = 0          # calls that launched; never counts a CPU call
wkv6_bwd.launches_chunked = 0  # of which the chunked design (bf16)
wkv6_bwd.launches_entry = 0    # of which walked the chunk-entry states first

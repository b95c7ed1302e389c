"""Flash-attention backward: wrappers of the two hand-written CUDA kernels.

The kernels (`csrc/flash_attention_bwd.cu`) replace the TPU kernels
`_bwd_dkv_kernel` and `_bwd_dq_kernel` of the JAX package.  Like them they take
the MHA layout: the op (ops.py) expands K/V to the query heads and sums dK/dV
over each GQA group.  On a CUDA tensor a wrapper launches its kernel or raises;
on a CPU tensor it runs the plain version in `ref`, which computes the same
function.  There is no fallback from one to the other.

D = rowsum(dO o O) is a reduction outside the kernels, as in the JAX package
(`kernel_bwd.py:163` there); here it is one torch op.

Each kernel has two variants, picked by the inputs' dtype.  bf16 inputs run
on the tensor cores: P and dS are rounded to bf16 before the dV = P^T dO and
dK = dS^T Q products, and dS before the dQ = dS K product, whose sums stay in
f32.  That rounding is the one numerical difference from the TPU kernels and
from the plain versions, which multiply them in f32.  f32 inputs run the
CUDA-core variants, all in f32.  `launches` counts every launch of a wrapper,
`launches_tc` the tensor-core ones.
"""
from __future__ import annotations

import torch

from . import ref
from .kernel import _DTYPES, HEAD_DIMS, check_aligned


def _check(q, k, v, do, lse, dvec):
    """Raise on what the kernels do not take."""
    tensors = (q, k, v, do, lse, dvec)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"inputs must share one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(f"q, k, v, do must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if lse.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise ValueError("lse and dvec must be float32")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if (k.shape != (b, h, sk, d) or v.shape != k.shape or do.shape != q.shape
            or lse.shape != (b, h, sq) or dvec.shape != lse.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, dvec {tuple(dvec.shape)} do not fit "
                         f"the MHA layout (B,H,Sq,D)/(B,H,Sk,D)/(B,H,Sq)")
    if min(b, h, sq, sk) == 0:
        raise ValueError("empty batch, head or sequence dimension")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def _launch_args(q, k, scale, causal, window):
    b, h, sq, d = q.shape
    return (b * h, sq, k.shape[2], d, _DTYPES[q.dtype], float(scale), int(causal),
            int(window is not None), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dkv(q, k, v, do, lse, dvec, *, scale: float,
                            causal: bool, window: int | None):
    """(dk, dv), each (B, H, Sk, D) in q's dtype.  MHA layout."""
    if q.device.type == "cpu":
        return ref.attention_bwd_dkv(q, k, v, do, lse, dvec, scale=scale,
                                     causal=causal, window=window)
    _check(q, k, v, do, lse, dvec)
    check_aligned(q, k, v, do)
    from .._build import library  # builds with nvcc on first use

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library().flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_launch_args(q, k, scale, causal, window))
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: cudaError {err}")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_tc += q.dtype == torch.bfloat16
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, dvec, *, scale: float,
                           causal: bool, window: int | None):
    """dq (B, H, Sq, D) in q's dtype.  MHA layout."""
    if q.device.type == "cpu":
        return ref.attention_bwd_dq(q, k, v, do, lse, dvec, scale=scale,
                                    causal=causal, window=window)
    _check(q, k, v, do, lse, dvec)
    check_aligned(q, k, v, do)
    from .._build import library  # builds with nvcc on first use

    dq = torch.empty_like(q)
    err = library().flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dq.data_ptr(), *_launch_args(q, k, scale, causal, window))
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: cudaError {err}")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_tc += q.dtype == torch.bfloat16
    return dq


flash_attention_bwd_dkv.launches = 0     # kernel launches; never counts a CPU call
flash_attention_bwd_dkv.launches_tc = 0  # of which the tensor-core (bf16) variant
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_tc = 0   # of which the tensor-core (bf16) variant


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool,
                        window: int | None):
    """MHA backward.  q, o, do: (B, H, Sq, D); k, v: (B, H, Sk, D); lse
    (B, H, Sq) f32.  Returns (dq, dk, dv) in q's dtype."""
    if q.device.type == "cpu":
        return ref.attention_bwd(q, k, v, o, lse, do, scale=scale, causal=causal,
                                 window=window)
    dvec = (do.float() * o.float()).sum(-1)
    kw = {"scale": scale, "causal": causal, "window": window}
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
    return dq, dk, dv

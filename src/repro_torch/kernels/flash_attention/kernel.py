"""Flash-attention forward: the wrapper of the hand-written CUDA kernel.

The kernel (`csrc/flash_attention_fwd.cu`) replaces the TPU kernel
`_flash_kernel` of the JAX package.  On a CUDA tensor this wrapper launches it
or raises; on a CPU tensor it runs the plain version `ref.attention_fwd_lse`,
which computes the same function.  There is no fallback from one to the other.

The kernel has two variants, picked by the inputs' dtype.  bf16 inputs run on
the tensor cores: P is rounded to bf16 before the P.V product, whose sums
stay in f32, and the softmax denominator is summed from the unrounded P.
That rounding is the one numerical difference from the TPU kernel and from
the plain version, which multiply P in f32.  f32 inputs run the CUDA-core
variant, all in f32.  `launches` counts every launch, `launches_tc` the
tensor-core ones.

The TPU version padded Sq and Sk to its 512-wide VMEM blocks; the CUDA kernel
picks its own 64 x 64 tiles and masks the ragged edge itself, so `block_q` and
`block_k` are accepted for signature parity and not used.
"""
from __future__ import annotations

import torch

from . import ref

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)  # 96: MLA's nope 64 + rope 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_aligned(*tensors):
    """The tensor-core variants copy 16-byte chunks: bf16 data must start on a
    16-byte boundary (a fresh allocation does; a view with an offset may not)."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 inputs must start on a 16-byte boundary")


def flash_attention_fwd_lse(q, k, v, *, scale: float, causal: bool,
                            window: int | None, block_q: int = 512,
                            block_k: int = 512):
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D) -> (out, logsumexp).

    out: (B, Hq, Sq, D) in q's dtype; lse: (B, Hq, Sq) float32.
    """
    del block_q, block_k
    if q.device.type == "cpu":
        return ref.attention_fwd_lse(q, k, v, scale=scale, causal=causal,
                                     window=window)
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one CUDA device; got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if bk != b or dk != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B,Hq,Sq,D)/(B,Hkv,Sk,D)")
    if min(b, hq, sq, sk) == 0:
        raise ValueError("empty batch, head or sequence dimension")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    check_aligned(q, k, v)

    from .._build import library  # builds with nvcc on first use

    lib = library()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, hq, hkv, sq, sk, d, _DTYPES[q.dtype], float(scale), int(causal),
        int(window is not None), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd_lse.launches += 1
    flash_attention_fwd_lse.launches_tc += q.dtype == torch.bfloat16
    return out, lse


flash_attention_fwd_lse.launches = 0     # kernel launches; never counts a CPU call
flash_attention_fwd_lse.launches_tc = 0  # of which the tensor-core (bf16) variant

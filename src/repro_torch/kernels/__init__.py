"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  flash_attention : online-softmax attention forward (causal / sliding-window /
                    bidirectional, GQA), replacing the TPU `_flash_kernel`,
                    and its backward (dK/dV and dQ kernels), replacing
                    `_bwd_dkv_kernel` and `_bwd_dq_kernel`.

Each kernel's sources live in `csrc/` and are built with nvcc at first use
(`_build.py`).  `rg_lru` and `wkv6` come with the slices that port their
architectures.
"""
from .flash_attention.ops import flash_attention

__all__ = ["flash_attention"]

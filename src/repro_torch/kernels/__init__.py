"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  flash_attention : online-softmax attention forward (causal / sliding-window /
                    bidirectional, GQA), replacing the TPU `_flash_kernel`,
                    and its backward (dK/dV and dQ kernels), replacing
                    `_bwd_dkv_kernel` and `_bwd_dq_kernel`.
  rg_lru          : the RG-LRU gated linear recurrence (recurrentgemma-9b),
                    replacing `_rg_lru_kernel`.
  wkv6            : the RWKV-6 data-dependent-decay recurrence (rwkv6-3b),
                    replacing `_wkv6_kernel`.

Each kernel's sources live in `csrc/` and are built with nvcc at first use
(`_build.py`).  Every TPU kernel of the JAX package has its CUDA counterpart.
"""
from .flash_attention.ops import flash_attention
from .rg_lru.ops import rg_lru
from .wkv6.ops import wkv6

__all__ = ["flash_attention", "rg_lru", "wkv6"]

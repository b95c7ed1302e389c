"""PyTorch / CUDA port of the JAX package `repro`, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout and is
held against it by the `tests/test_torch_*.py` parity tests.  It imports
`torch`, `numpy` and the standard library only, never `jax` or `repro`.

Ported so far: the dense decoder (`models`), the flash-attention forward as a
hand-written CUDA kernel (`kernels`), and the serving driver (`launch.serve`).
"""

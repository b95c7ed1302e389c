"""PyTorch / CUDA port of the JAX package `repro`, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout and is
held against it by the `tests/test_torch_*.py` parity tests.  It imports
`torch`, `numpy` and the standard library only, never `jax` or `repro`.

Ported so far: the dense decoder (`models`), with its loss and remat; the
flash-attention forward and backward as hand-written CUDA kernels
(`kernels`); the serving driver (`launch.serve`); the training driver
(`launch.train`) with AdamW (`optim`), the synthetic data stream (`data`),
and the Bridge gradient sync: the BRIDGE schedule core (`core`), the planner
(`planner`) and the Bruck collectives over `torch.distributed`
(`collectives`).
"""

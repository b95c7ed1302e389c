"""RWKV-6 recurrence: plain version (`ref`), CUDA kernel wrapper (`kernel`), op (`ops`)."""

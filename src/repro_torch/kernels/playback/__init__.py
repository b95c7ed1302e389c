"""Certified fabric playback (B6): plain version (`ref`), CUDA kernel wrapper (`kernel`)."""

"""RG-LRU recurrence: plain version (`ref`), CUDA kernel wrapper (`kernel`), op (`ops`)."""

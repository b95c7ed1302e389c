"""Flash attention: plain versions (`ref`), CUDA kernel wrapper (`kernel`), op (`ops`)."""

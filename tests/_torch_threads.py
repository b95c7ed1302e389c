"""Torch's CPU threads for the port's tests, set once a process.

Each pytest-xdist worker would otherwise start one intra-op thread per host
CPU, so six workers oversubscribe the host several times over and the plain
versions' many small ops wait on each other's threads.  Every
`tests/test_torch_*.py` imports this module; the first import in a process
gives each worker its share of the CPUs.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

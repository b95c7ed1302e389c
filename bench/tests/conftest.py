"""The benchmark's tests: its contract, its yardstick, and its runs on the
CPU at a tiny size (the harness's look for a card skipped).  Tests that need
the card carry the `cuda` marker and skip inside the `card` fixture."""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

# each xdist worker its share of the CPUs for torch's intra-op threads
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 2, "num_kv_heads": 2, "d_ff": 128,
        "vocab_size": 256, "dtype": "float32"}
TINY_RWKV = {"num_heads": 4, "num_kv_heads": 4, "rwkv_head_dim": 16}


def tiny_cell(name: str, **traffic):
    """A cell of BENCHMARK.json with its configuration cut to a tiny float32
    model and its traffic to a few short rows, its limits as they are."""
    from harness import spec
    cell = spec.cell(spec.load(ROOT), name, ROOT)
    arch = dict(cell.config["arch"], **TINY)
    if cell.config["reference"] == "rwkv6":
        arch.update(TINY_RWKV)
    cell.config = dict(cell.config, arch=arch)
    small = ({"batch_per_rank": 2, "seq": 32, "ranks": 1} if cell.traffic["kind"] == "train"
             else {"requests": 4, "prompt": 16, "output": 8})
    cell.traffic = {**cell.traffic, **small, **traffic}
    return cell


def cpu_run(cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3, trace: bool = False,
            rank: int = 0, world: int = 1):
    """One run of `cell` on the CPU; rank 0 returns the result line."""
    from harness import runner
    return runner.run(runner.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                                     device=torch.device("cpu"), rank=rank, world=world,
                                     t0=time.time()))


@pytest.fixture
def card():
    """The card, or a skip where there is none; afterwards this process's
    cached blocks go back to the card (a run the next test starts needs them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda", 0)
    import gc
    gc.collect()
    torch.cuda.empty_cache()

"""The comparison catches a broken timed path: each fault a cell can have,
planted in the program underneath a tiny run on the CPU (the harness's look
for a card skipped), turns `correct` false under the cell's own limits; and
the control, the reference with fp8 products put in the program's place,
reads far above the program."""
from __future__ import annotations

import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import calibrate
from conftest import cpu_run, tiny_cell

from harness import faults, runner


@pytest.mark.parametrize("fault,name", [
    ("unchanged", "stablelm-3b.train"),
    ("half_batch", "stablelm-3b.train"),
    ("stale_state", "rwkv6-3b.serve"),
    ("half_served", "rwkv6-3b.serve"),
    ("token", "rwkv6-3b.serve"),
])
def test_a_planted_fault_makes_the_run_incorrect(fault, name):
    cell = tiny_cell(name)
    assert cpu_run(cell)["correct"] is True
    with faults.planted(fault):
        line = cpu_run(cell)
    assert line["correct"] is False, line["checks"]


def _ranks(rank, world, port, fault, out):
    torch.set_num_threads(1)
    line = None
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        cell = tiny_cell("stablelm-3b.train-dp4-bridge", ranks=world)
        with faults.planted(fault):
            line = cpu_run(cell, rank=rank, world=world)
        dist.destroy_process_group()
    finally:
        if rank == 0:
            out.put(line)  # None where the rank failed


@pytest.mark.parametrize("fault", [None, "no_exchange", "rank1_unsynced"])
def test_the_exchange_left_out_makes_the_multi_rank_run_incorrect(fault):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_ranks, args=(r, 2, port, fault, out)) for r in range(2)]
    for p in procs:
        p.start()
    line = out.get(timeout=240)
    assert line is not None, "rank 0 failed"
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert line["correct"] is (fault is None), line["checks"]
    if fault == "rank1_unsynced":  # rank 0's own state is right: the gap is rank 1's
        assert line["checks"]["grad_gap"]["value"] > line["checks"]["grad_gap"]["limit"]
    assert set(line["metrics"]) == {"train_tokens_per_s.dp4", "setup_s"}


def _readings(cell, seed):
    ctx = runner.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                         device=torch.device("cpu"), t0=time.time())
    return {r["what"]: r for r in calibrate.readings(ctx, control=True, faults=[])}


def test_the_training_control_reads_far_above_the_program():
    cell = tiny_cell("stablelm-3b.train", batch_per_rank=2, seq=64)
    rows = _readings(cell, 3)
    assert all(rows["program"][k] <= v for k, v in cell.limits.items()), rows["program"]
    assert any(rows["control"][k] > v for k, v in cell.limits.items()), rows["control"]


def test_the_serving_control_reads_far_above_the_program():
    cell = tiny_cell("rwkv6-3b.serve", output=32)   # 128 served positions
    rows = _readings(cell, 4)
    program, control = rows["program"]["logit_gap"], rows["control"]["logit_gap"]
    # a tiny float32 model: the program picks the reference's tokens, the
    # control's fp8 products do not (at the cell's size: test_bench_card.py)
    assert program <= cell.limits["logit_gap"] and control > 3 * program
    assert control > 0, rows

"""Multi-process checks of the port over `torch.distributed` with gloo (CPU).

One process per rank: `python tests/_torch_dist_worker.py MODE RANK WORLD PORT
[ARGS]`.  `spawn` starts all ranks on a free localhost port and fails at a
time limit rather than hanging.  Imports no JAX.

Modes:
  collectives       the port of tests/_multidevice_worker.py's RS / AG /
                    all-reduce checks, against NumPy sums; prints 'ok <name>'
                    per check and 'ALL-OK'.
  a2a IN OUT        bruck_all_to_all of row `rank` of the (n, n, ...) array
                    in the .npy file IN; each rank writes its output to
                    OUT.<rank>.npy.
  compressed OUT    two rounds of compressed_all_reduce (the second with the
                    first's error feedback) on two seeded gradient leaves
                    per rank; rank 0 writes both rounds' sums and every
                    rank's inputs to the .npz file OUT.
  train PARAMS OUT [MODE ...]
                    trains stablelm-3b smoke (4 steps, batch 8, seq 32) with
                    each grad_sync MODE in turn (default: gspmd, then
                    bridge), from the weights in the .npz file PARAMS (JAX
                    tree layout, flattened); rank 0 writes the loss lists,
                    by mode, to the JSON file OUT.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, world: int, *args: str, timeout: float = 120.0) -> list[str]:
    """Run `world` ranks of this worker; returns each rank's stdout.  Raises
    AssertionError if a rank fails or the run passes `timeout` seconds (every
    rank is killed then)."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), port,
                               *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        raise AssertionError(f"{mode} on {world} gloo ranks passed its {timeout} s "
                             f"limit") from None
    for r, (proc, out) in enumerate(zip(procs, outs, strict=True)):
        assert proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n{out}"
    return outs


def _collectives(n: int, rank: int) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import (bridge_all_reduce, bruck_all_gather,
                                         bruck_all_reduce, bruck_reduce_scatter,
                                         ring_all_gather, ring_all_reduce,
                                         ring_reduce_scatter)
    from repro_torch.core.cost_model import PAPER_DEFAULT
    from repro_torch.planner import PlanRequest, default_planner

    rng = np.random.default_rng(0)  # every rank draws the same global arrays

    def check(name, got, want):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0, err_msg=name)
        if rank == 0:
            print("ok", name, flush=True)

    def schedule(kind, m_bytes):
        return default_planner().plan(PlanRequest(
            kind=kind, n=n, m_bytes=m_bytes, cost_model=PAPER_DEFAULT)).schedule

    # reduce-scatter: rank j's contribution x[j] (n, 6); block i of the sum at rank i
    x = rng.standard_normal((n, n, 6)).astype(np.float32)
    want = x.sum(axis=0)[rank]
    mine = torch.from_numpy(x[rank])
    check("bruck_reduce_scatter", bruck_reduce_scatter(mine), want)
    check("ring_reduce_scatter", ring_reduce_scatter(mine), want)
    if n > 1:  # the planner plans for two ranks or more
        check("bruck_reduce_scatter(schedule)",
              bruck_reduce_scatter(mine, schedule("rs", 6 * 4.0)), want)

    # all-gather: rank p's block x[p] (5,); every rank gets all n blocks
    x = rng.standard_normal((n, 5)).astype(np.float32)
    mine = torch.from_numpy(x[rank])
    check("bruck_all_gather", bruck_all_gather(mine), x)
    check("ring_all_gather", ring_all_gather(mine), x)
    if n > 1:
        check("bruck_all_gather(schedule)", bruck_all_gather(mine, schedule("ag", 5 * 4.0)), x)

    # all-reduce on a (7, 11) tensor, deliberately not divisible by n
    x = rng.standard_normal((n, 7, 11)).astype(np.float32)
    want = x.sum(axis=0)
    mine = torch.from_numpy(x[rank])
    check("ring_all_reduce", ring_all_reduce(mine), want)
    check("bruck_all_reduce", bruck_all_reduce(mine), want)
    check("bridge_all_reduce", bridge_all_reduce(mine, PAPER_DEFAULT), want)
    if rank == 0:
        print("ALL-OK", flush=True)


def _a2a(n: int, rank: int, in_path: str, out_path: str) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import bruck_all_to_all

    x = torch.from_numpy(np.load(in_path)[rank])
    np.save(f"{out_path}.{rank}.npy", bruck_all_to_all(x).numpy())


def _compressed(n: int, rank: int, out_path: str) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import compressed_all_reduce, make_error_feedback_state

    rng = np.random.default_rng(0)  # every rank draws the same global arrays
    glob = [rng.standard_normal((n, 33)).astype(np.float32) * 3.0,
            rng.standard_normal((n, 4, 5)).astype(np.float32)]
    grads = [torch.from_numpy(g[rank]) for g in glob]
    ef = make_error_feedback_state(grads)
    out1, ef = compressed_all_reduce(grads, ef)
    # second round on the same grads: error feedback corrects round-1 error
    out2, _ = compressed_all_reduce(grads, ef)
    if rank == 0:
        np.savez(out_path, **{f"g{i}": g for i, g in enumerate(glob)},
                 **{f"round1_{i}": t.numpy() for i, t in enumerate(out1)},
                 **{f"round2_{i}": t.numpy() for i, t in enumerate(out2)})
    torch.distributed.barrier()


def _train(n: int, rank: int, params_path: str, out_path: str, *modes: str) -> None:
    import numpy as np
    import torch

    from repro_torch.interop import params_from_jax
    from repro_torch.launch.train import TrainConfig, model_config, train

    flat = np.load(params_path)
    tree: dict = {}
    for key in flat.files:  # "a/b/c" -> tree["a"]["b"]["c"]; list indices as ints
        node, parts = tree, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    tree = lists(tree)
    kw = {"arch": "stablelm-3b", "steps": 4, "batch_size": 8, "seq_len": 32}
    losses = {}
    for mode in modes or ("gspmd", "bridge"):
        tc = TrainConfig(grad_sync=mode, **kw)
        model = params_from_jax(model_config(tc), tree, device="cpu")
        _, _, losses[mode] = train(tc, progress=lambda *_: None, device="cpu", model=model)
    if rank == 0:
        Path(out_path).write_text(json.dumps(losses))
    torch.distributed.barrier()


def main() -> None:
    mode, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if mode == "collectives":
            _collectives(world, rank)
        elif mode == "a2a":
            _a2a(world, rank, *sys.argv[5:7])
        elif mode == "compressed":
            _compressed(world, rank, sys.argv[5])
        elif mode == "train":
            _train(world, rank, *sys.argv[5:])
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

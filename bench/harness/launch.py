"""One process a card for a cell on several cards, as `run.py` and
`calibrate.py` start them, and each rank's join to the group (NCCL, with
the rendezvous over TCP on a free localhost port: no store file)."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list[str], chips: int, deadline: float = float("inf"),
          echo: bool = False) -> tuple[int, list[str]]:
    """Run `argv --rank <r> --port <p>` once a card and wait for every rank.
    Ranks above 0 write to standard error; rank 0's standard output comes
    back (and with `echo` is printed as it comes).  A rank that fails, or the
    wall clock (`time.time()`) passing `deadline`, stops the others (124 for
    the deadline).  Returns the exit code and rank 0's lines."""
    port = free_port()
    procs = []
    for rank in range(chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(chips),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([*argv, "--rank", str(rank), "--port", str(port)],
                                      env=env, text=True,
                                      stdout=subprocess.PIPE if rank == 0 else sys.stderr.fileno()))
    lines: list[str] = []

    def read():
        for line in procs[0].stdout:
            lines.append(line)
            if echo:
                print(line, end="", flush=True)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                code = failed[0].returncode if failed else 124
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    reader.join(timeout=30)
    return code or next((p.returncode for p in procs if p.returncode), 0), lines


def join(rank: int, chips: int, port: int | None):
    """This rank's card, made current, and on several cards the process
    group joined; returns the device."""
    import torch
    import torch.distributed as dist
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if chips > 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=chips, rank=rank, device_id=device)
    return device

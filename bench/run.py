"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(`chips` in BENCHMARK.json).  The last line of standard output is the
result, one JSON object; the numbers compared for `correct` are also the last
lines of standard error, each beside its limit.  A cell on several cards
starts one process a card here (rendezvous over TCP on a free localhost
port), and rank 0 prints the line.

The program's kernel library builds into `build/` inside the checkout (the
port's fixed directory); a Triton or CUDA JIT cache, were one used, goes
under `build/` too.  Nothing here reads the JAX package or `benchmarks/`,
and a run that finds `jax`, `jaxlib`, `flax` or `repro` loaded fails.
"""
from __future__ import annotations

import time

T0 = time.time()  # noqa: E402  (set-up counts from the process's start)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LIMIT_S = 1150  # a multi-card run's ranks are stopped past this (a hang)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is exactly one of FORBIDDEN (the
    port's `repro_torch` is not `repro`)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def spawn(args, chips: int) -> tuple[int, dict | None]:
    """Start one rank a card (`harness.launch`) and wait for all; returns the
    exit code and rank 0's result."""
    from harness import launch
    argv = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
            str(args.trace), "--t0", repr(T0)]
    code, lines = launch.spawn(argv, chips, deadline=T0 + LIMIT_S)
    if code == 0 and not lines:
        code = 1   # rank 0 ended without its result
    return code, json.loads(lines[-1]) if code == 0 else None


def report(line: dict) -> None:
    """The numbers compared, as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    for var, sub in (("TRITON_CACHE_DIR", "triton-cache"), ("CUDA_CACHE_PATH", "cuda-cache")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    from harness import spec
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        code, line = spawn(args, cell.chips)
        if code:
            return code
    else:
        line = run_rank(args, cell)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    if line is not None:
        report(line)
    return 0


def run_rank(args, cell) -> dict | None:
    """This process's rank of the run; rank 0 returns the result."""
    import torch.distributed as dist
    from harness import launch, runner
    rank = args.rank or 0
    device = launch.join(rank, cell.chips, args.port)
    try:
        return runner.run(runner.Context(
            cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=device, rank=rank, world=cell.chips,
            t0=T0 if args.t0 is None else args.t0))
    finally:
        if cell.chips > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits, read on the card at the cell's own
sizes, many seeds in one process (set-up is paid once a seed, and no window
is needed):

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--control 2] [--faults half_batch,no_exchange] [--fault-seeds 2]

For each seed: the program's numbers against the f32 reference (what a run
compares); on the first `--control` seeds also the control's (the reference
computed with fp8 products, put in the program's place); on the first
`--fault-seeds` seeds the program's with each fault of `--faults` planted
(see `harness/faults.py`).  One JSON object a reading on standard output.
A cell on several cards starts one process a card, as `run.py` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(ctx, control: bool, faults: list[str]) -> list[dict]:
    import torch
    from harness import faults as faults_mod
    from harness import port
    from harness import train as train_mod
    if ctx.cell.traffic["kind"] == "train":
        t = time.perf_counter()
        tr, prog = train_mod.check_steps(ctx)
        del tr
        port.release()
        got = {"program": prog}
        for name in faults:
            with faults_mod.planted(name):
                tr, got[name] = train_mod.check_steps(ctx)
            del tr
            port.release()
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = train_mod.reference_steps(ctx, "f32")
        t_ref = time.perf_counter() - t
        if control:
            got["control"] = train_mod.reference_steps(ctx, "fp8")
        return [{"seed": ctx.seed, "what": what, "program_s": t_prog, "reference_s": t_ref,
                 "loss": r["loss"], "reference_loss": ref["loss"],
                 **train_mod.worst_over_ranks(ctx, train_mod.gaps(r, ref))}
                for what, r in got.items()]
    from harness import serve as serve_mod
    from harness import traffic as feed_mod
    cfg = port.arch_config(ctx.cell.config)
    traffic = ctx.cell.traffic
    model = port.model(cfg, serve_mod._weights(ctx, getattr(torch, cfg.dtype)))
    lines = []
    prompts = feed_mod.serve_prompts(ctx.seed, feed_mod.SERVE, 0, traffic, cfg.vocab_size)
    t = time.perf_counter()
    outs = port.serve(cfg, model, prompts, traffic["output"], lines.append, ctx.device)
    t_prog = time.perf_counter() - t
    del model
    port.release()
    picks = feed_mod.sample(ctx.seed, len(outs), traffic["sample_requests"])
    t = time.perf_counter()
    gap = serve_mod.served_gaps(ctx, [(prompts[j], outs[j]) for j in picks],
                                "fp8" if control else None)
    t_ref = time.perf_counter() - t
    return [{"seed": ctx.seed, "what": what, "program_s": t_prog, "reference_s": t_ref,
             "lines": lines, "logit_gap": v} for what, v in gap.items()]


def rank_main(args) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import torch.distributed as dist
    from harness import launch, runner, spec
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    rank = args.rank or 0
    device = launch.join(rank, cell.chips, args.port)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(seeds):
        ctx = runner.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                             rank=rank, world=cell.chips, t0=time.time())
        rows = readings(ctx, i < args.control, faults if i < args.fault_seeds else [])
        if rank == 0:
            for row in rows:
                print(json.dumps(row), flush=True)
    if cell.chips > 1:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    chips = {w["name"]: w["chips"]
             for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if args.rank is not None or chips[args.workload] == 1:
        rank_main(args)
        return 0
    sys.path.insert(0, str(ROOT / "bench"))
    from harness import launch
    return launch.spawn([sys.executable, __file__, *sys.argv[1:]], chips[args.workload],
                        echo=True)[0]


if __name__ == "__main__":
    sys.exit(main())

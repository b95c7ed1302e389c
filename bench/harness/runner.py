"""One run of one cell in this process (one rank of it on several cards):
the cell's driver, then the result line that rank 0 prints.

With `--trace 0` the line's metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, each read by its reader file from the
run's record (a reader that finds nothing to read returns None, and the
metric is left out).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import platform
import sys

import torch
import torch.distributed as dist

from . import spec
from .trace import top_kernels

GIB = 2 ** 30


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    rank: int = 0
    world: int = 1
    t0: float = 0.0            # the run's start on the wall clock (time.time())

    def log(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)

    def gather(self, peak: int, reduced: dict | None):
        """The fullest card's peak, and rank 0's trace with the busy and
        window seconds averaged over the ranks beside its own."""
        if self.world == 1:
            return peak, reduced
        got = [None] * self.world
        dist.all_gather_object(got, (peak, None if reduced is None else
                                      (reduced["busy_s"], reduced["window_s"])))
        if reduced is not None:
            reduced = dict(reduced,
                           busy_s_mean=sum(g[1][0] for g in got) / self.world,
                           window_s_mean=sum(g[1][1] for g in got) / self.world)
        return max(g[0] for g in got), reduced


def run(ctx: Context) -> dict | None:
    """The cell's run; rank 0 returns the result line's object."""
    kind = ctx.cell.traffic["kind"]
    out = importlib.import_module(f"harness.{kind}").run(ctx)
    if ctx.rank != 0:
        return None
    return result(ctx, out)


def result(ctx: Context, out: dict) -> dict:
    gpu = ctx.device.type == "cuda"
    device = {"platform": "gpu" if gpu else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if gpu else platform.machine(),
              "count": ctx.world, "memory_peak_bytes": out["memory_peak_bytes"]}
    reduced = out["trace"]
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    if ctx.trace:
        record = dict(out["record"], platform=device["platform"], chips=ctx.world,
                      config=ctx.cell.arch, reference=ctx.cell.config["reference"],
                      traffic=ctx.cell.traffic, trace=reduced)
        values = {m["name"]: spec.reader(m["name"])(record) for m in ctx.cell.per_layer}
        if reduced is not None:
            device.update(busy_s=reduced.get("busy_s_mean", reduced["busy_s"]),
                          window_s=reduced.get("window_s_mean", reduced["window_s"]))
    else:
        values = dict(out["e2e"])
        if gpu:
            values["peak_mem_gib"] = out["memory_peak_bytes"] / GIB
        values = {m["name"]: values.get(m["name"]) for m in ctx.cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    checks = {k: {"value": v, "limit": ctx.cell.limits[k]} for k, v in out["checks"].items()}
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace and reduced is not None:
        line["breakdown"] = {"device_ops": top_kernels(reduced["kernels"]),
                             "idle_gaps": reduced["gaps"][:10]}
    line["checks"] = checks   # last: each number compared, beside its limit
    return line

"""The traced stretch of a `--trace 1` run: `torch.profiler` (CPU and CUDA)
around a few steps or batches after the measured window, reduced on the
spot to what the metric readers and the result's `breakdown` need.

The reduction reads the profiler's raw events (building its Python event
list takes seconds for a decode's hundreds of thousands of kernels):
  kernels   {short name: [launches, device seconds]} of every device event
  busy_s    the union of the device events' intervals inside the stretch
  window_s  the stretch's length (the `bench.window` annotation)
  gaps      [[what the host was doing, idle seconds]]: each idle interval of
            the device named by the innermost host event that covers its
            middle (an op, a runtime call or a span of the benchmark)
"""
from __future__ import annotations

import contextlib
import heapq
import re

import torch

_HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    n = name.strip()
    n = n[5:] if n.startswith("void ") else n
    n = n.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", n, maxsplit=1)[0].strip() or name[:80]


class Stretch:
    """`with Stretch(device) as s: ...` profiles the block; `s.reduced`
    holds the reduction afterwards (None on the CPU: no device trace)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.reduced = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function("bench.window")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None and self.device.type == "cuda":
            self.reduced = reduce(self._prof.profiler.kineto_results.events())
        return False


def reduce(events) -> dict:
    from torch.autograd import DeviceType
    window, device, host = None, [], []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if dur > 0 and kind != "gpu_user_annotation":
                device.append((start, start + dur, name))
        elif name == "bench.window":
            window = (start, start + dur)
        elif dur > 0 and (kind is None or kind in _HOST_KINDS):
            host.append((start, start + dur, name))
    # a span's shadow on the device timeline (a `record_function` of the
    # benchmark, or c10d's "nccl:coalesced") carries the span's host name; a
    # kernel, copy or memset never does (where the build's events carry no
    # activity type, this is how the shadows are told apart)
    spans = {name for _, _, name in host} | {"bench.window"}
    device = [d for d in device if d[2] not in spans]
    if window is None or not device:
        return None
    lo, hi = window
    kernels = {}
    for s, t, name in device:
        k = kernels.setdefault(short_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e9
    busy, gaps, cursor = 0, [], lo
    for s, t, _ in sorted(device):
        s, t = max(s, lo), min(t, hi)
        if t <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += t - max(s, cursor)
        cursor = t
    if cursor < hi:
        gaps.append((cursor, hi))
    return {"kernels": kernels, "busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> list:
    """[[host activity, idle seconds]], summed by activity, longest first."""
    host.sort()
    active, i, named = [], 0, {}
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            s, t, name = host[i]
            heapq.heappush(active, (t - s, t, name))
            i += 1
        while active and active[0][1] <= mid:   # ended before this gap
            heapq.heappop(active)
        # the shortest covering event is the innermost; an ended one below
        # the top is dropped when it surfaces, as the middles only grow
        name = active[0][2] if active else "(no host event)"
        named[name] = named.get(name, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])


def top_kernels(kernels: dict, n: int = 10) -> list:
    return sorted(([k, v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:n]


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark's own around a call into the program."""
    with torch.profiler.record_function(name):
        yield

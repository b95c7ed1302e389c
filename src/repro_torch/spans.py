"""Spans and device timers of the port's drivers.

`span(name)` marks a phase of a driver as a host event on the profiler's
clock, beside the device trace, so a trace names the device's idle time by
the innermost span that covers it.  It enters a `record_function` only while
a profiler runs: unguarded one costs ~15 us an enter and exit with no
profiler, the check a flag read.

`Marks` times device work between points of the current stream with CUDA
events, for the drivers' own lines with no profiler running: it never
synchronises, and its reads wait for nothing once the host has read a result
that the stream computed after the last point.

The spans (their users read them in a trace) and what reads the timers:
  serve.prefill, serve.decode.warmup, serve.decode.capture,
  serve.decode.replay, serve.decode.read     `launch.serve` (its marks: each
                                             replay's start and end)
  train.forward, train.backward, train.sync, train.sync.leaf,
  train.metrics, train.optimizer             `launch.train.make_train_step`
                                             (its marks: the phases' ends)
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span(name): ...`: a `torch.profiler.record_function(name)` while
    a profiler runs, else a no-op that adds no event."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class Marks:
    """CUDA events recorded at points of the current stream, kept from one
    round to the next (events hold no device memory).  `reset()` starts a
    round and `mark(device)` records its next point on `device`'s current
    stream, a no-op off the card; `intervals()` and `elapsed()` read the
    round once the host has waited past its last point, and are None where
    the round recorded nothing (off the card)."""

    def __init__(self):
        self._events: list = []
        self._n = 0

    def reset(self) -> None:
        self._n = 0

    def mark(self, device: torch.device) -> None:
        if device.type != "cuda":
            return
        if self._n == len(self._events):
            self._events.append(torch.cuda.Event(enable_timing=True))
        self._events[self._n].record(torch.cuda.current_stream(device))
        self._n += 1

    def intervals(self) -> list[float] | None:
        """The device seconds between each point of the round and the next."""
        if not self._n:
            return None
        ev = self._events[:self._n]
        return [a.elapsed_time(b) / 1e3 for a, b in zip(ev, ev[1:])]

    def elapsed(self) -> float | None:
        """The device seconds from the round's first point to its last."""
        if not self._n:
            return None
        return self._events[0].elapsed_time(self._events[self._n - 1]) / 1e3

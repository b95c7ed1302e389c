"""Batched serving driver of the port: prefill once, then greedy decode.

The port of `repro.launch.serve`: fixed-batch slots, greedy decode,
per-request stop lengths, KV caches managed by the model's cache protocol.
The reference jits its step once and calls it per token; on the card the
port captures its step once as a CUDA graph and replays it per token
(`CapturedDecode`), and on the CPU (or with `graph=False`) runs the same
step as an eager Python loop.

Each batch prints a `prefill:` and a `decode:` line on the host clock, then a
`decode spans:` line (`decode_spans_line`): each replay timed on the device
by CUDA events (`spans.Marks`), the gaps between the host's reads of the ids,
the warm-up and the capture.  Under a profiler the phases are the spans
`serve.prefill`, `serve.decode.warmup`, `serve.decode.capture`,
`serve.decode.replay` and `serve.decode.read` (`spans.span`).

Run on the card (random weights from a seed, scaled-down config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
Run on the CPU with the plain versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
`--arch` takes any id of `repro_torch.configs.ARCHS` and defaults to the
reference's rwkv6-3b; the recurrent archs (rwkv6-3b, recurrentgemma-9b) keep
their recurrent states in the caches.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.model import greedy
from repro_torch.spans import Marks, span


@functools.cache
def _warmup_stream(index: int) -> torch.cuda.Stream:
    """The side stream of every warm-up on card `index`: cuBLAS keeps a
    workspace for each stream it has run on (32 MiB on the H100), so a new
    stream a capture would hold one more workspace for each capture."""
    return torch.cuda.Stream(torch.device("cuda", index))


@functools.cache
def _replay_marks(index: int) -> Marks:
    """The events of every decode on card `index` (each replay's start and
    end), reused from batch to batch."""
    return Marks()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)


class CapturedDecode:
    """One greedy decode step over `caches` (the caches `prefill` returned,
    on the card), captured once as a `torch.cuda.CUDAGraph` and replayed per
    token: the counterpart of the reference's `jax.jit` of `decode_step`.

    Building it runs the first step eagerly on a side stream from `token`
    (B, 1), the prefill's greedy ids: the warm-up, which builds and loads the
    kernels (and, on a mesh, creates the NCCL communicators) and advances the
    caches as a real step does.  Then it captures the next step without
    running it.  `token` is the static buffer the step reads and writes its
    greedy ids into; `logits` the step's logits (this rank's vocab slice),
    valid until the next replay; `step()` replays the graph and returns
    `token`.  Every cache leaf is written in place and the position is a
    device tensor, so each replay continues where the last one stopped.
    Capture or replay errors propagate; nothing falls back to the eager
    loop.  `warmup_s` and `capture_s` are the two parts' host seconds."""

    def __init__(self, cfg, model, caches, token):
        if token.device.type != "cuda":
            raise ValueError(f"a CUDA graph captures a step on the card; the token is on "
                             f"{token.device}")
        self.cfg, self.model, self.caches = cfg, model, caches
        self.token = token.clone()
        dev = token.device
        t0 = time.perf_counter()
        side = _warmup_stream(dev.index)
        side.wait_stream(torch.cuda.current_stream(dev))
        with span("serve.decode.warmup"), torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)  # no collective of the warm-up is left in flight
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # on a mesh the NCCL watchdog's thread queries events while this one
        # captures: only this thread's calls must be capture-safe
        mode = "thread_local" if dist.is_available() and dist.is_initialized() else "global"
        with span("serve.decode.capture"), torch.cuda.graph(self.graph, capture_error_mode=mode):
            self.logits = self._step()
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        self.replays = 0

    def _step(self):
        logits, _ = decode_step(self.cfg, self.model, self.token, self.caches,
                                logits_whole=False)
        self.token.copy_(greedy(self.cfg, self.model, logits)[:, None])
        return logits

    def step(self):
        self.graph.replay()
        self.replays += 1
        return self.token


@torch.inference_mode()
def decode_loop(cfg, model, caches, tok, budgets: list[int], graph: bool,
                progress=print) -> torch.Tensor:
    """Greedy decode from `tok` (B, 1), the prefill's greedy ids, over
    `caches` until row i holds `budgets[i]` ids (the longest budget's steps
    for every row).  Returns the ids read on the host, (B, max(budgets)),
    `tok`'s first.  With `graph` (on the card), the first step runs eagerly
    and the next is captured once (`CapturedDecode`), where a replay follows,
    and every later step replays it; else every step runs eagerly.  The host
    reads each step's ids once, outside the graph, as the reference's
    `np.asarray(tok)`.  Prints two progress lines: the decoded tokens, steps,
    seconds and tok/s, and how the steps ran (the graph's warm-up and capture
    seconds and its replays); then `decode_spans_line`'s."""
    steps = max(budgets) - 1
    captured, eager = None, 0
    marks = _replay_marks(tok.device.index) if tok.device.type == "cuda" else Marks()
    marks.reset()
    t0 = time.perf_counter()
    with span("serve.decode.read"):
        host = [tok.cpu()]  # waits for the device
    reads = [time.perf_counter()]
    for i in range(steps):
        if captured is not None:
            with span("serve.decode.replay"):
                marks.mark(tok.device)
                tok = captured.step()
                marks.mark(tok.device)
        elif graph and i + 1 < steps:  # a replay follows: warm up and capture
            captured = CapturedDecode(cfg, model, caches, tok)
            tok = captured.token
            eager += 1
        else:
            logits, caches = decode_step(cfg, model, tok, caches, logits_whole=False)
            tok = greedy(cfg, model, logits)[:, None]
            eager += 1
        with span("serve.decode.read"):
            host.append(tok.cpu())
        reads.append(time.perf_counter())
    dt = time.perf_counter() - t0
    # the first id of each row came from prefill; count only decode's
    decoded = sum(max(n - 1, 0) for n in budgets)
    how = ("eager" if captured is None else
           f"CUDA graph: warm-up and capture {captured.warmup_s + captured.capture_s:.3f}s, "
           f"{captured.replays} replays")
    progress(f"decode: {decoded} tokens in {steps} steps, {dt:.3f}s "
             f"({decoded / max(dt, 1e-9):.1f} tok/s), {how}")
    progress(decode_spans_line(captured, eager, marks, reads, tok.device))
    return torch.cat(host, dim=1)


def decode_spans_line(captured: CapturedDecode | None, eager: int, marks: Marks,
                      reads: list[float], device: torch.device) -> str:
    """One batch's decode, as sums and counts that pool over batches: its
    replays, captures and eager steps; the replays' device seconds (each
    from an event just before `graph.replay()` to one just after), the
    device seconds between one replay's end and the next one's start (the
    ids' read, the host loop, the next launch) and the stretch from the first
    replay's start to the last one's end (on the card, with replays); the
    host-clock gaps between consecutive reads of the ids (nearest-rank
    percentiles; the first gap holds the warm-up step and the capture); and
    the warm-up's and the capture's host seconds."""
    replays = 0 if captured is None else captured.replays
    parts = [f"decode spans: {replays} replays, {int(captured is not None)} captures, "
             f"{eager} eager"]
    got = marks.intervals()
    if got is None:
        parts.append(f"device not timed ({'no replays' if device.type == 'cuda' else 'cpu'})")
    else:
        parts.append(f"replays {sum(got[0::2]):.6f} s device, between replays "
                     f"{sum(got[1::2]):.6f} s device, stretch {marks.elapsed():.6f} s device")
    gaps = sorted(b - a for a, b in zip(reads, reads[1:]))
    if gaps:
        def at(q):
            return 1e3 * gaps[math.ceil(q * len(gaps)) - 1]
        parts.append(f"token gap ms p50 {at(0.5):.3f} p95 {at(0.95):.3f} max {at(1.0):.3f} "
                     f"(host, {len(gaps)} gaps)")
    if captured is not None:
        parts.append(f"warm-up {captured.warmup_s:.6f} s, capture {captured.capture_s:.6f} s")
    return "; ".join(parts)


@torch.inference_mode()
def serve_requests(cfg, model, requests: list[Request], max_seq: int,
                   progress=print, device=None, graph: bool | None = None
                   ) -> dict[int, list[int]]:
    """Batch all requests together (same prompt length), prefill once, decode
    until every request hits its token budget.  Returns rid -> token ids.

    Runs on `device` (default `cuda`), where `model` must already live, under
    `torch.inference_mode()`: the parameters are trainable, and serving
    builds no autograd graph.

    `graph` (None: on a CUDA device): after prefill, the first decode step
    runs eagerly, the next is captured once (`CapturedDecode`) and every
    later token replays it; the ids are the eager loop's, the same kernels
    running in the same order.  `graph=False` runs every step eagerly, the
    same step; `graph=True` on the CPU raises ValueError (no CUDA graph
    there).  The decode runs in `decode_loop`.

    On a mesh (tensor parallelism over its 'model' axis), as the reference's
    dry run builds its prefill and decode steps: every rank shards the model
    (`launch.shardings.shard_model(model, mesh, fsdp=False)`, or
    `launch.shardings.init_sharded(..., mesh, fsdp=False)`) and calls this with
    the same requests inside `models.sharding.activation_sharding(mesh,
    launch.shardings.activation_rules(mesh))`; each rank computes its heads
    and channels, its caches hold them, and every rank returns the same
    tokens.  The greedy pick reads each rank's vocab slice of the logits
    (`models.model.greedy`), so no rank holds the whole vocab's.  Every rank
    captures the same collectives in the same order."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model on {model.device}, serving on {dev}")
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device; serving on {dev}")
    use_graph = dev.type == "cuda" if graph is None else graph
    batch = len(requests)
    prompts = torch.from_numpy(np.stack([r.prompt for r in requests])).to(model.device)
    t0 = time.perf_counter()
    with span("serve.prefill"):
        logits, caches = prefill(cfg, model, {"tokens": prompts}, max_seq=max_seq,
                                 logits_whole=False)
        tok = greedy(cfg, model, logits)[:, None]
        tok.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    n = prompts.numel()
    progress(f"prefill: {batch} x {prompts.shape[1]} tokens in {dt:.3f}s "
             f"({n / max(dt, 1e-9):.1f} tok/s)")
    ids = decode_loop(cfg, model, caches, tok, [r.max_new_tokens for r in requests],
                      use_graph, progress)
    for r, row in zip(requests, ids.tolist(), strict=True):
        r.out.extend(row[:r.max_new_tokens])
    return {r.rid: r.out for r in requests}


def build_parser() -> argparse.ArgumentParser:
    """The reference's options and defaults, and `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    return ap


def main():
    args = build_parser().parse_args()

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).scaled_down()
    generator = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, generator, dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    out = serve_requests(cfg, model, reqs,
                         max_seq=args.prompt_len + args.new_tokens + 1,
                         device=dev)
    for rid, toks in out.items():
        print(f"request {rid}: {toks}")


if __name__ == "__main__":
    main()

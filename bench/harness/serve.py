"""The serving driver: traffic of kind "serve".

A closed loop of offline batches: `requests` prompts of `prompt` uniform ids
go to the port's `serve_requests` together, each asking for `output` greedy
tokens, and the next batch (new prompts from the seed) goes in when one
returns.  Set-up serves one batch of the same shapes (it builds the kernels,
and the capture of the decode step runs once).  After the window the
program's state is freed and the plain reference runs once over a sample of
the finished requests (`sample_requests`, drawn from the seed), over each
prompt with its served tokens:

  logit_gap  the widest gap by which a served token's logit lies below the
             reference's best at its position (greedy ids: 0 where the
             program picked the reference's argmax).

A request whose answer never came, or came short, counts as failed.
"""
from __future__ import annotations

import time

import torch

from . import port
from . import traffic as feed_mod
from .trace import Stretch, span


def _weights(ctx, dtype):
    gen = feed_mod.generator(ctx.seed, feed_mod.WEIGHTS, 0, ctx.device)
    return ctx.cell.reference().draw(ctx.cell.arch, gen, dtype)


def run(ctx) -> dict:
    cell, traffic = ctx.cell, ctx.cell.traffic
    cfg = port.arch_config(cell.config)
    dtype = getattr(torch, cfg.dtype)
    model = port.model(cfg, _weights(ctx, dtype))
    out_len = traffic["output"]
    lines: list[str] = []

    def serve(prompts):
        with span("bench.serve_batch"):
            return port.serve(cfg, model, prompts, out_len, lines.append, ctx.device)

    serve(feed_mod.serve_prompts(ctx.seed, feed_mod.WARM, 0, traffic, cfg.vocab_size))
    lines.clear()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)

    t_setup = time.time() - ctx.t0
    t0, done, i = time.perf_counter(), [], 0
    while time.perf_counter() - t0 < ctx.seconds:
        prompts = feed_mod.serve_prompts(ctx.seed, feed_mod.SERVE, i, traffic, cfg.vocab_size)
        done.append((prompts, serve(prompts), time.perf_counter() - t0))
        i += 1
    ends = [round(d[2], 3) for d in done]
    ctx.log(f"batches returned at {ends} s of the window")
    in_window = [d for d in done if d[2] <= ctx.seconds] or done[:1]
    served = sum(len(o) for _, outs, _ in in_window for o in outs if o)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    window_lines = list(lines)

    reduced = None
    if ctx.trace:
        with Stretch(ctx.device) as stretch:
            for _ in range(traffic["profile_batches"]):
                serve(feed_mod.serve_prompts(ctx.seed, feed_mod.SERVE, i, traffic,
                                             cfg.vocab_size))
                i += 1
        reduced = stretch.reduced
    del model
    port.release()

    finished = [(p, o) for prompts, outs, _ in done for p, o in zip(prompts, outs, strict=True)]
    failed = sum(1 for _, o in finished if o is None or len(o) != out_len)
    picks = feed_mod.sample(ctx.seed, len(finished), traffic["sample_requests"])
    sample = [finished[j] for j in picks if finished[j][1] and len(finished[j][1]) == out_len]
    gap = served_gaps(ctx, sample)["program"] if sample else float("inf")
    return {"e2e": {traffic["rate_metric"]: served / in_window[-1][2], "setup_s": t_setup},
            "memory_peak_bytes": peak,
            "attempted": len(finished), "failed": failed,
            "record": {"window": {"seconds": in_window[-1][2], "batches": len(in_window),
                                  "requests": traffic["requests"],
                                  "tokens_per_batch": traffic["requests"] * (
                                      traffic["prompt"] + out_len - 1)},
                       "lines": window_lines,
                       "profiled_batches": traffic["profile_batches"]},
            "trace": reduced,
            "checks": {"logit_gap": gap}}


@torch.no_grad()
def served_gaps(ctx, sample: list, control: str | None = None) -> dict:
    """The widest gap of the served tokens below the reference's best logit
    over the sampled (prompt, served ids); with `control` (a precision), also
    the widest gap of the token that the control's logits put first at the
    same positions."""
    from reference import common
    cell = ctx.cell
    ref, arch = cell.reference(), cell.arch
    cfg = port.arch_config(cell.config)
    common.strict_f32()
    tree = _f32(_weights(ctx, getattr(torch, cfg.dtype)))
    p = len(sample[0][0])
    tokens = torch.tensor([list(pr) + list(out[:-1]) for pr, out in sample],
                          dtype=torch.long, device=ctx.device)
    served = torch.tensor([list(out) for _, out in sample], dtype=torch.long, device=ctx.device)
    z = ref.logits(arch, tree, ref.hidden(arch, tree, tokens, "f32")[:, p - 1:], "f32")
    best = z.max(-1).values
    out = {"program": float((best - z.gather(-1, served[..., None])[..., 0]).max())}
    if control is not None:
        zc = ref.logits(arch, tree, ref.hidden(arch, tree, tokens, control)[:, p - 1:], control)
        pick = zc.argmax(-1)
        out["control"] = float((best - z.gather(-1, pick[..., None])[..., 0]).max())
    return out


def _f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, list):
        return [_f32(t) for t in tree]
    return {k: _f32(t) for k, t in tree.items()}

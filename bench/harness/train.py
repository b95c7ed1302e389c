"""The training driver: traffic of kind "train".

Set-up draws the weights from the seed, builds the port's training step
(`make_train_step`) with its AdamW state on this process's world, and drives
that same object through the mix's `check_steps` first steps on the feed the
window uses (they warm up every kernel and shape too).  The window then runs
steps until `--seconds` have passed; a `--trace 1` run profiles
`profile_steps` more.  After the window the program's state is freed and the
plain reference follows the check steps from the same weights and rows:

  loss_gap   the widest relative gap of a check step's loss;
  grad_gap   the first step's gradient as the optimizer got it (read from its
             first moment, m = (1 - b1) g scale, and the reported norm before
             clipping), leaf by leaf: the widest gap of the program's norm from
             the reference's, over the larger of that leaf's reference norm
             and the median leaf's;
  delta_gap  the same of each leaf's change over the check steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by rounding alone and are left out of both leaf numbers.
On several cards every rank compares its own state, and each number is the
largest over the ranks.
"""
from __future__ import annotations

import math
import statistics
import time

import torch
import torch.distributed as dist

from . import port
from . import traffic as feed_mod
from .trace import Stretch, span

B1 = 0.9          # AdamW's first-moment decay in the port and the reference
RULE = 1e-3       # leaves under this share of the median gradient norm are left out


def leaf(tree: dict, name: str):
    """A weight of the benchmark's tree by the model's parameter name
    ("blocks.3.mix.wq")."""
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _weights(ctx, dtype):
    gen = feed_mod.generator(ctx.seed, feed_mod.WEIGHTS, 0, ctx.device)
    return ctx.cell.reference().draw(ctx.cell.arch, gen, dtype)


def _feed(ctx, cfg):
    traffic = ctx.cell.traffic
    return lambda i: feed_mod.train_batch(ctx.seed, i, traffic, cfg.vocab_size, ctx.device,
                                          ctx.rank)


def check_steps(ctx):
    """Set-up: the port's training step on the seed's weights, driven
    through the mix's check steps on the window's feed.  Returns the step
    object (`port.Trainer`) and the program's readings."""
    traffic = ctx.cell.traffic
    cfg = port.arch_config(ctx.cell.config)
    dtype = getattr(torch, cfg.dtype)
    feed = _feed(ctx, cfg)
    tr = port.trainer(cfg, _weights(ctx, dtype), traffic)
    names = [n for n, _ in tr.model.named_parameters()]
    prog = {"loss": []}
    for i in range(traffic["check_steps"]):
        metrics = tr.step(feed(i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            scale = min(1.0, 1.0 / max(float(metrics["grad_norm"]), 1e-12))
            norms = torch.stack([m.norm() for m in tr.opt_state.m]).cpu().tolist()
            prog["grad"] = {n: x / (1 - B1) / scale for n, x in zip(names, norms, strict=True)}
    start = _weights(ctx, dtype)
    with torch.no_grad():
        prog["delta"] = dict(zip(names, torch.stack(
            [(p.float() - leaf(start, n).float()).norm()
             for n, p in tr.model.named_parameters()]).cpu().tolist(), strict=True))
    return tr, prog


def run(ctx) -> dict:
    traffic = ctx.cell.traffic
    cfg = port.arch_config(ctx.cell.config)
    feed = _feed(ctx, cfg)
    tr, prog = check_steps(ctx)
    plan = None
    if ctx.world > 1 and ctx.rank == 0:
        grad_bytes = sum(p.numel() * p.element_size() for p in tr.model.parameters())
        plan = port.sync_plan(traffic, grad_bytes)
        ctx.log(f"gradient sync plan ({traffic['grad_sync']}, {grad_bytes} bytes, "
                f"{traffic['ranks']} ranks): {plan.impl}, predicted "
                f"{plan.predicted_time * 1e3:.3f} ms under the port's assumed H100 NVLink "
                f"costs (not measured)")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    if ctx.world > 1:
        dist.barrier()

    # the window
    t_setup = time.time() - ctx.t0
    t0, ends, i = time.perf_counter(), [], traffic["check_steps"]
    while True:
        go = time.perf_counter() - t0 < ctx.seconds
        if ctx.world > 1:  # rank 0's clock decides for every rank
            flag = torch.tensor([int(go)], device=ctx.device)
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        if not go:
            break
        with span("bench.train_step"):
            float(tr.step(feed(i))["loss"])
        ends.append(time.perf_counter() - t0)
        i += 1
    done = [t for t in ends if t <= ctx.seconds] or ends[:1]
    _log_steps(ctx, ends)
    tokens = traffic["batch_per_rank"] * traffic["ranks"] * traffic["seq"]
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    reduced = None
    if ctx.trace:
        with Stretch(ctx.device) as stretch:
            for _ in range(traffic["profile_steps"]):
                with span("bench.train_step"):
                    float(tr.step(feed(i))["loss"])
                i += 1
        reduced = stretch.reduced
        if plan is not None and reduced is not None:
            nccl = sum(v[1] for k, v in reduced["kernels"].items() if "nccl" in k.lower())
            ctx.log(f"gradient sync: predicted {plan.predicted_time * 1e3:.3f} ms a step, "
                    f"NCCL kernels {nccl / traffic['profile_steps'] * 1e3:.3f} ms a traced "
                    f"step on rank 0 (waiting on peers included)")
    peak, reduced = ctx.gather(peak, reduced)
    del tr
    port.release()

    return {"e2e": {traffic["rate_metric"]: len(done) * tokens / done[-1], "setup_s": t_setup},
            "memory_peak_bytes": peak,
            "attempted": len(ends), "failed": 0,
            "record": {"window": {"steps": len(ends), "seconds": ends[-1],
                                  "tokens_per_step": tokens},
                       "profiled_steps": traffic["profile_steps"]},
            "trace": reduced,
            "checks": worst_over_ranks(ctx, gaps(prog, reference_steps(ctx, "f32")))}


def _log_steps(ctx, ends: list) -> None:
    """Each rank's step times in the window, on rank 0's standard error."""
    steps = [round(b - a, 4) for a, b in zip([0.0, *ends], ends)]
    got = [steps]
    if ctx.world > 1:
        got = [None] * ctx.world
        dist.all_gather_object(got, steps)
    if ctx.rank == 0:
        for r, s in enumerate(got):
            ctx.log(f"rank {r} step seconds in the window: {s}")


def worst_over_ranks(ctx, checks: dict) -> dict:
    """Each number compared, the largest over the ranks (a rank whose state
    went wrong is caught though rank 0's is right)."""
    if ctx.world == 1:
        return checks
    vals = torch.tensor(list(checks.values()), dtype=torch.float64, device=ctx.device)
    dist.all_reduce(vals, op=dist.ReduceOp.MAX)
    return dict(zip(checks, vals.cpu().tolist(), strict=True))


def reference_steps(ctx, prec: str) -> dict:
    """The plain reference through the check steps from the seed's weights
    and rows, in `prec`: each step's loss, the first step's gradient norms
    leaf by leaf and each leaf's change over the steps.  On several ranks each
    computes its rows and the gradients are summed by the library's
    all-reduce."""
    from reference import common
    cell, traffic = ctx.cell, ctx.cell.traffic
    ref, arch = cell.reference(), cell.arch
    cfg = port.arch_config(cell.config)
    dtype = getattr(torch, cfg.dtype)
    feed = _feed(ctx, cfg)
    common.strict_f32()
    tree = _weights(ctx, dtype)
    names = _names(tree)
    params = {n: leaf(tree, n).float().requires_grad_() for n in names}
    del tree
    tree32 = _rebuild(params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    rows, seq = traffic["batch_per_rank"], traffic["seq"]
    out = {"loss": []}
    for step in range(1, traffic["check_steps"] + 1):
        batch = feed(step - 1)
        total = torch.zeros((), dtype=torch.float32, device=ctx.device)
        for j in range(rows):
            nll = ref.nll_sum(arch, tree32, batch["tokens"][j:j + 1], batch["labels"][j:j + 1],
                              prec, remat=True) / (rows * seq)
            nll.backward()
            total += nll.detach()
        grads = [params[n].grad for n in names]
        if ctx.world > 1:
            for g in grads:
                dist.all_reduce(g)
                g /= ctx.world
            dist.all_reduce(total)
            total /= ctx.world
        out["loss"].append(float(total))
        if step == 1:
            out["grad"] = dict(zip(names, torch.stack([g.norm() for g in grads]).cpu().tolist(),
                                   strict=True))
        lr = common.lr_at(step, traffic["lr"], traffic["warmup"], traffic["schedule_steps"])
        common.adamw_step([params[n] for n in names], grads, [m[n] for n in names],
                          [v[n] for n in names], step, lr, store_dtype=dtype)
        for p in params.values():
            p.grad = None
    del m, v, grads
    start = _weights(ctx, dtype)
    with torch.no_grad():
        out["delta"] = dict(zip(names, torch.stack(
            [(params[n] - leaf(start, n).float()).norm() for n in names]).cpu().tolist(),
            strict=True))
    return out


def _names(tree: dict, prefix: str = "") -> list[str]:
    """The weights' names in the model's parameter order."""
    if isinstance(tree, torch.Tensor):
        return [prefix[:-1]]
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    return [n for k, sub in items for n in _names(sub, f"{prefix}{k}.")]


def _rebuild(params: dict) -> dict:
    """The tree of `params` ({name: tensor}), as `draw` lays it out."""
    tree: dict = {}
    for name, t in params.items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared, from the program's readings (or the
    control's) against the reference's."""
    loss = worst([abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"], strict=True)])
    med = statistics.median(ref["grad"].values())
    kept = [n for n, g in ref["grad"].items() if g >= RULE * med]
    grad = worst([abs(prog["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], med)
                  for n in kept])
    med_d = statistics.median(ref["delta"][n] for n in kept)
    delta = worst([abs(prog["delta"][n] - ref["delta"][n]) / max(ref["delta"][n], med_d)
                   for n in kept])
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta}


def worst(values: list) -> float:
    """The largest value; infinite where one is not a number."""
    return max(values) if all(map(math.isfinite, values)) else math.inf

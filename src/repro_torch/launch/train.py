"""Training driver of the port: data-parallel train loop with BRIDGE gradient
sync over `torch.distributed`.

The port of `repro.launch.train`.  Every rank holds the whole model and
computes the loss and gradients of its rows of the global batch; gradients
are then summed across ranks and divided by the world size:
  gspmd  : the library all-reduce, `dist.all_reduce(SUM)` — the counterpart
           of the all-reduce the reference's GSPMD inserts;
  bridge : the paper's technique.  `gradient_sync_plan` picks, under the
           `H100_NVLINK` cost model, the Bruck reduce-scatter + all-gather
           (with the planner's schedules), the ring, or the library
           all-reduce, run per gradient leaf;
  bridge-compressed : the int8 all-reduce with error feedback
           (`compressed_all_reduce`), the residuals kept across steps from
           zero; it quantizes on one rank too, as the reference does.
The loss and metrics are averaged across ranks, as `pmean` does.

The world is `torch.distributed` when it is initialised (`torchrun`), else one
rank.  Rank r takes rows [r B/n, (r+1) B/n) of `SyntheticLM.global_batch`, so
the global batch does not depend on the world size.  Ranks run on
`cuda:{LOCAL_RANK}` (NCCL), or on the CPU (gloo) when `device="cpu"`.

Checkpoint/restart as the reference's: with `checkpoint_dir`, a run resumes
from the newest step found there (the parameters written into the model in
place, the AdamW state onto the device) and saves `{"params", "opt"}` every
`checkpoint_every` steps in the reference's train-state layout (rank 0
writes), so a checkpoint of either package resumes in the other.  Not ported
yet, and refused with NotImplementedError: 2-D meshes (ROADMAP A9).

Run (random weights from a seed, scaled-down config unless --scale full):
  PYTHONPATH=src python -m repro_torch.launch.train            # rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.train --scale full --arch stablelm-3b
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --checkpoint-dir ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --grad-sync bridge
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs, interop
from repro_torch._device import resolve_device
from repro_torch.checkpoint import latest_step, restore_into, save
from repro_torch.collectives import (bruck_all_reduce, compressed_all_reduce,
                                     gradient_sync_plan, make_error_feedback_state,
                                     ring_all_reduce)
from repro_torch.core.cost_model import H100_NVLINK
from repro_torch.data import SyntheticLM
from repro_torch.models.model import Model, init_params, loss_fn
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_warmup_schedule


@dataclasses.dataclass
class TrainConfig:
    """The reference's fields and defaults (`repro.launch.train.TrainConfig`)."""

    arch: str = "rwkv6-3b"
    scale: str = "smoke"             # smoke (scaled_down) | full
    steps: int = 20
    batch_size: int = 8              # global
    seq_len: int = 64
    lr: float = 3e-4
    warmup: int = 10
    grad_sync: str = "gspmd"         # gspmd | bridge | bridge-compressed
    checkpoint_dir: str | None = None
    checkpoint_every: int = 10
    mesh_shape: tuple = ()
    mesh_axes: tuple = ()
    seed: int = 0


GRAD_SYNCS = ("gspmd", "bridge", "bridge-compressed")


def _check_supported(tc: TrainConfig) -> None:
    if tc.grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got {tc.grad_sync!r}")
    if tc.mesh_shape:
        raise NotImplementedError("mesh_shape: 2-D meshes are not ported to PyTorch "
                                  "yet: ROADMAP A9")


def model_config(tc: TrainConfig):
    cfg = configs.get(tc.arch)
    if tc.scale == "smoke":
        cfg = cfg.scaled_down()
        cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg


@dataclasses.dataclass(frozen=True)
class World:
    """The data-parallel group (the default process group): its size and this
    process's rank in it."""

    size: int = 1
    rank: int = 0


def current_world() -> World:
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_world_size(), dist.get_rank())
    return World()


def sync_gradients(grads: list[torch.Tensor], grad_sync: str, world: World,
                   ef_state: list[torch.Tensor] | None = None):
    """Sum gradient leaves across the world and divide by its size.  Returns
    (grads, ef_state): `bridge-compressed` reads and replaces the error
    feedback residuals, the other modes pass them through."""
    n = world.size
    if grad_sync == "bridge-compressed":
        grads, ef_state = compressed_all_reduce(grads, ef_state)
        for g in grads:  # f32 sums of this call's own: divided in place
            g /= n
        return grads, ef_state
    if n == 1:
        return grads, ef_state
    if grad_sync == "gspmd":
        for g in grads:
            dist.all_reduce(g, op=dist.ReduceOp.SUM)
    else:
        plan = gradient_sync_plan(
            n, sum(g.numel() * g.element_size() for g in grads), H100_NVLINK)
        if plan.impl == "bruck":
            grads = [bruck_all_reduce(g, plan.rs_schedule, plan.ag_schedule)
                     for g in grads]
        elif plan.impl == "ring":
            grads = [ring_all_reduce(g) for g in grads]
        else:
            for g in grads:
                dist.all_reduce(g, op=dist.ReduceOp.SUM)
    return [g / n for g in grads], ef_state


def _pmean(x: torch.Tensor, world: World) -> torch.Tensor:
    x = x.detach().clone()
    if world.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        x /= world.size
    return x


def make_train_step(cfg, tc: TrainConfig, world: World):
    """step(model, opt_state, batch, ef) -> (opt_state, metrics, ef); the
    model's parameters are updated in place, and `ef` is the error feedback
    state of `bridge-compressed` (None for the other modes)."""
    lr = cosine_warmup_schedule(tc.lr, tc.warmup, tc.steps)

    def step(model: Model, opt_state, batch: dict, ef=None):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(cfg, model, batch)
        loss.backward()
        grads, ef = sync_gradients([p.grad for p in params], tc.grad_sync, world, ef)
        metrics = {k: _pmean(m, world) for k, m in metrics.items()}
        _, opt_state, om = adamw_update(grads, opt_state, params, lr)
        metrics.update(om)
        metrics["loss"] = _pmean(loss, world)
        return opt_state, metrics, ef

    return step


def state_tree(model: Model, opt_state: AdamWState, params=None) -> dict:
    """The reference's train state `{"params": ..., "opt": AdamWState}` in
    its tree layout, from the model's parameters (or `params`, one tensor
    per parameter) and the port's AdamW state."""
    params = [p.detach() for p in model.parameters()] if params is None else params
    return {"params": interop.tree_from_tensors(model, params),
            "opt": AdamWState(step=opt_state.step,
                              m=interop.tree_from_tensors(model, opt_state.m),
                              v=interop.tree_from_tensors(model, opt_state.v))}


def restore_state(directory: str, step: int, model: Model) -> AdamWState:
    """Restore the train state of `step`: the parameters are written into
    `model` in place, and the AdamW state comes back on the model's device."""
    params = list(model.parameters())
    meta = [torch.empty_like(p, device="meta") for p in params]
    f32 = [torch.empty_like(p, dtype=torch.float32, device="meta") for p in params]
    template = state_tree(model, AdamWState(
        step=torch.zeros((), dtype=torch.int32, device="meta"), m=f32, v=f32), meta)
    state = restore_into(directory, template, step=step, device=model.device)
    with torch.no_grad():
        for p, value in zip(params, interop.tensors_from_tree(model, state["params"]),
                            strict=True):
            p.copy_(value)
    opt = state["opt"]
    return AdamWState(step=opt.step, m=interop.tensors_from_tree(model, opt.m),
                      v=interop.tensors_from_tree(model, opt.v))


def _rank_device(device) -> torch.device:
    """`device`, with `cuda` (or None) meaning `cuda:{LOCAL_RANK}`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def train(tc: TrainConfig, progress=print, device=None, model: Model | None = None):
    """Train `tc.steps` steps.  Returns (model, opt_state, losses).

    Runs on `device` (default `cuda:{LOCAL_RANK}`).  `model` is a test seam,
    not a feature: the parity tests pass the weights converted from the JAX
    package's initialisation, and `chip_smoke.py` a model cut in depth where
    the whole one does not fit a card (it must live on `device` and match
    `tc`'s config but for `num_layers`, whose value it keeps); by default the
    weights are drawn from `tc.seed`.  Either way, rank 0's weights are
    broadcast so every rank starts from the same ones."""
    _check_supported(tc)
    cfg = model_config(tc)
    world = current_world()
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if tc.batch_size % world.size:
        raise ValueError(f"global batch {tc.batch_size} does not split over "
                         f"{world.size} ranks")
    data = SyntheticLM(cfg.vocab_size, tc.seq_len, seed=tc.seed)

    if model is None:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(tc.seed), dev)
    elif dataclasses.replace(cfg, num_layers=model.cfg.num_layers) != model.cfg \
            or model.device != dev:
        raise ValueError(f"model ({model.cfg.name} on {model.device}) does not match "
                         f"the run ({cfg.name} on {dev})")
    cfg = model.cfg
    if world.size > 1:
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=0)
    opt_state = adamw_init(list(model.parameters()))
    ef = (make_error_feedback_state(list(model.parameters()))
          if tc.grad_sync == "bridge-compressed" else None)
    step_fn = make_train_step(cfg, tc, world)

    start = 0
    if tc.checkpoint_dir:
        last = latest_step(tc.checkpoint_dir)
        if last is not None:
            t0 = time.perf_counter()
            opt_state = restore_state(tc.checkpoint_dir, last, model)
            start = last
            progress(f"resumed from step {start} ({time.perf_counter() - t0:.4f} s)")

    per_rank = tc.batch_size // world.size
    rows = slice(world.rank * per_rank, (world.rank + 1) * per_rank)
    losses = []
    for step in range(start, tc.steps):
        # one stream per example: the global batch is identical for any world
        # size (the rows of this rank are cut from it)
        host_batch = data.global_batch(step, tc.batch_size, 1)
        batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in host_batch.items()}
        t0 = time.perf_counter()
        opt_state, metrics, ef = step_fn(model, opt_state, batch, ef)
        loss = float(metrics["loss"])  # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        progress(f"step {step:5d} loss {loss:.4f} "
                 f"gnorm {float(metrics['grad_norm']):.3f} dt {dt:.4f}s")
        if tc.checkpoint_dir and (step + 1) % tc.checkpoint_every == 0 and world.rank == 0:
            t0 = time.perf_counter()
            path = save(tc.checkpoint_dir, step + 1, state_tree(model, opt_state))
            progress(f"saved step {step + 1} to {path} ({time.perf_counter() - t0:.4f} s)")
    return model, opt_state, losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--scale", default="smoke")
    ap.add_argument("--grad-sync", default="gspmd")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default cuda:{LOCAL_RANK}; 'cpu' runs the plain versions")
    return ap


def main():
    args = build_parser().parse_args()
    tc = TrainConfig(arch=args.arch, steps=args.steps,
                     batch_size=args.batch_size, seq_len=args.seq_len,
                     scale=args.scale, grad_sync=args.grad_sync,
                     checkpoint_dir=args.checkpoint_dir)
    dev = _rank_device(args.device)
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1  # torchrun
    if launched:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        rank = dist.get_rank() if launched else 0
        _, _, losses = train(tc, progress=print if rank == 0 else (lambda *_: None),
                             device=dev)
        if rank == 0:
            print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Training driver of the port: the train loop with BRIDGE gradient sync over
`torch.distributed`, on a mesh or not.

The port of `repro.launch.train`.  The world is `torch.distributed` when it
is initialised (`torchrun`), else one rank; ranks run on `cuda:{LOCAL_RANK}`
(NCCL), or on the CPU (gloo) when `device="cpu"`.  Each rank computes the
loss and gradients of its rows of `SyntheticLM.global_batch` (rank i of n
takes rows [i B/n, (i+1) B/n), so the global batch does not depend on the
layout), and the loss and metrics are averaged across the ranks that hold
distinct rows, as `pmean` does.

Without `mesh_shape` every rank holds the whole model and gradients are
summed across ranks and divided by the world size:
  gspmd  : the library all-reduce, `dist.all_reduce(SUM)` — the counterpart
           of the all-reduce the reference's GSPMD inserts;
  bridge : the paper's technique.  `gradient_sync_plan` picks, under the
           `H100_NVLINK` cost model, the Bruck reduce-scatter + all-gather
           (with the planner's schedules), the ring, or the library
           all-reduce, run per gradient leaf;
  bridge-compressed : the int8 all-reduce with error feedback
           (`compressed_all_reduce`), the residuals kept across steps from
           zero; it quantizes on one rank too, as the reference does.
(The reference's default is a `(device_count,)` 'data' mesh; the math is the
same, the layout differs: pass `mesh_shape=(n,), mesh_axes=("data",)` for
the reference's layout.)

With `mesh_shape` / `mesh_axes` (a `DeviceMesh` over the whole world,
`launch.mesh`):
  gspmd  : the parameters and AdamW moments live only as their shards under
           the rule table (`launch.shardings.shard_model`), gathered where
           the model reads them to their compute layout; the rows lie over
           the batch axes, as the reference's `batch_shardings` lays them,
           and the 'model' peers of a data shard compute the same rows with
           the dense projections split between them (tensor parallelism,
           `models.tensor_parallel`) and the MoE's experts run in parallel
           over it (`models.moe`); the gradient of each shard comes back
           summed over the ranks that hold distinct rows and is divided by
           their number.
  bridge, bridge-compressed : as the reference's `shard_map`: parameters
           replicated, the batch split over 'data' (the ranks of one data
           shard compute the same rows), gradients summed over the 'data'
           subgroup by the paper's collectives.
Under `gspmd` (mesh or not) the MoE forms the reference's global token
groups across ranks (`models.sharding.TokenSplit`); the `bridge` modes keep
each rank's own groups, as the reference's per-shard `loss_fn` does.

Checkpoint/restart as the reference's: with `checkpoint_dir`, a run resumes
from the newest step found there, whatever layout wrote it (elastic
restart: each rank keeps its shard of every leaf, `restore_into(...,
sharding_fn=)`), and saves `{"params", "opt"}` every `checkpoint_every` steps
in the reference's unsharded train-state layout (sharded leaves are gathered
by every rank, rank 0 writes), so a checkpoint of either package resumes in
the other.

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

from torch.distributed.tensor import DTensor, Shard

from repro_torch import configs, interop
from repro_torch._device import resolve_device
from repro_torch.checkpoint import latest_step, restore_into, save
from repro_torch.collectives import (bruck_all_reduce, compressed_all_reduce,
                                     gradient_sync_plan, make_error_feedback_state,
                                     ring_all_reduce)
from repro_torch.core.cost_model import H100_NVLINK
from repro_torch.data import SyntheticLM
from repro_torch.models.model import Model, init_params, loss_fn
from repro_torch.models.sharding import TokenSplit, activation_sharding
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_warmup_schedule

from .mesh import axis_sizes, batch_axes, make_mesh
from .shardings import activation_rules, local_shard, shard_model


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
    if len(tc.mesh_shape) != len(tc.mesh_axes):
        raise ValueError(f"mesh_shape {tc.mesh_shape} and mesh_axes {tc.mesh_axes}")
    if tc.mesh_shape and tc.grad_sync != "gspmd" and "data" not in tc.mesh_axes:
        raise ValueError(f"{tc.grad_sync} syncs over a 'data' axis: mesh_axes "
                         f"{tc.mesh_axes}")


def model_config(tc: TrainConfig):
    cfg = configs.get(tc.arch)
    if tc.scale == "smoke":
        cfg = cfg.scaled_down()
        cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg


@dataclasses.dataclass(frozen=True)
class World:
    """A group of ranks (`group`; None: the default process group): its size
    and this process's rank in it."""

    size: int = 1
    rank: int = 0
    group: object = None


def current_world() -> World:
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_world_size(), dist.get_rank())
    return World()


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a step's work lies.  `rows`: the ranks that hold distinct rows
    of the global batch (this rank's rows are its share of them; the loss
    and metrics are averaged over them); `sync`: the group whose gradients
    are summed by `sync_gradients` (None where the parameters are sharded
    and the sums come back with the shards); `split`: what the model reads
    (gspmd's global MoE groups, the expert-parallel group)."""

    rows: World
    sync: World | None
    sharded: bool
    split: TokenSplit | None


def layout(tc: TrainConfig, world: World, mesh) -> Layout:
    if mesh is None:
        split = (TokenSplit(tc.batch_size // world.size)
                 if tc.grad_sync == "gspmd" and world.size > 1 else None)
        return Layout(world, world, False, split)
    if tc.grad_sync == "gspmd":
        # the rows split over the batch axes, as the reference's batch
        # sharding; the 'model' peers of a data shard compute the same rows
        # and split the projections (and the MoE its tokens) between them
        model = mesh.get_group("model") if "model" in axis_sizes(mesh) else None
        tp = model if model is not None and dist.get_world_size(model) > 1 else None
        rows = batch_world(mesh)
        return Layout(rows, None, True,
                      TokenSplit(tc.batch_size // rows.size, rows.group, model, tp))
    data = World(mesh["data"].size(), mesh.get_local_rank("data"), mesh.get_group("data"))
    return Layout(data, data, False, None)


def batch_world(mesh) -> World:
    """The ranks that hold distinct rows under the reference's batch
    sharding: this rank's group over `batch_axes(mesh)`."""
    axes = batch_axes(mesh)
    if not axes:
        raise ValueError(f"a gspmd mesh needs a 'data' or 'pod' axis, not {mesh.mesh_dim_names}")
    sub = mesh[axes] if len(axes) == 1 else mesh[axes]._flatten()
    return World(sub.size(), sub.get_local_rank(), sub.get_group())


def sync_gradients(grads: list[torch.Tensor], grad_sync: str, world: World,
                   ef_state: list[torch.Tensor] | None = None):
    """Sum gradient leaves across the world and divide by its size.  Returns
    (grads, ef_state): `bridge-compressed` reads and replaces the error
    feedback residuals, the other modes pass them through."""
    n, group = world.size, world.group
    if grad_sync == "bridge-compressed":
        grads, ef_state = compressed_all_reduce(grads, ef_state, group)
        for g in grads:  # f32 sums of this call's own: divided in place
            g /= n
        return grads, ef_state
    if n == 1:
        return grads, ef_state
    if grad_sync == "gspmd":
        for g in grads:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    else:
        plan = gradient_sync_plan(
            n, sum(g.numel() * g.element_size() for g in grads), H100_NVLINK)
        if plan.impl == "bruck":
            grads = [bruck_all_reduce(g, plan.rs_schedule, plan.ag_schedule, group)
                     for g in grads]
        elif plan.impl == "ring":
            grads = [ring_all_reduce(g, group) for g in grads]
        else:
            for g in grads:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    return [g / n for g in grads], ef_state


def _pmean(x: torch.Tensor, world: World) -> torch.Tensor:
    x = x.detach().clone()
    if world.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=world.group)
        x /= world.size
    return x


def make_train_step(tc: TrainConfig, lay: Layout, mesh=None):
    """step(model, opt_state, batch, ef) -> (opt_state, metrics, ef): the
    loss of the model's own config (`model.cfg`); the model's parameters are
    updated in place, and `ef` is the error feedback state of
    `bridge-compressed` (None for the other modes)."""
    lr = cosine_warmup_schedule(tc.lr, tc.warmup, tc.steps)
    rules = {} if mesh is None else activation_rules(mesh)

    def step(model: Model, opt_state, batch: dict, ef=None):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        # the backward too: the remat recompute reads the split
        with activation_sharding(mesh, rules, lay.split):
            loss, metrics = loss_fn(model.cfg, model, batch)
            loss.backward()
        grads = [p.grad for p in params]
        if lay.sync is not None:
            grads, ef = sync_gradients(grads, tc.grad_sync, lay.sync, ef)
        elif lay.sharded and lay.rows.size > 1:
            # the shards came back summed over the ranks that hold distinct
            # rows (a 'model' peer's part of a leaf counted once)
            grads = [g / lay.rows.size for g in grads]
        metrics = {k: _pmean(m, lay.rows) for k, m in metrics.items()}
        _, opt_state, om = adamw_update(grads, opt_state, params, lr)
        metrics.update(om)
        metrics["loss"] = _pmean(loss, lay.rows)
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


def _whole(params: list, tensors: list, keep: bool) -> list:
    """`tensors`, one per parameter, whole: a sharded parameter's (or its
    moment's) shards gathered, a collective every rank takes part in; kept
    on the host where `keep`, else as meta tensors of the whole shape."""
    out = []
    for p, t in zip(params, tensors, strict=True):
        if isinstance(p, DTensor):
            if not isinstance(t, DTensor):  # a moment: this rank's shard
                t = DTensor.from_local(t, p.device_mesh, p.placements, run_check=False)
            t = t.full_tensor()
        out.append(t.detach().cpu() if keep else torch.empty_like(t, device="meta"))
    return out


def whole_state(model: Model, opt_state: AdamWState, keep: bool = True) -> dict:
    """`state_tree` of a sharded model: every rank gathers, and the ranks that
    `keep` hold the unsharded tree on the host."""
    params = list(model.parameters())
    return state_tree(model, AdamWState(step=opt_state.step.detach().cpu(),
                                        m=_whole(params, opt_state.m, keep),
                                        v=_whole(params, opt_state.v, keep)),
                      _whole(params, params, keep))


def _sharding_fn(model: Model):
    """restore_into's sharding_fn for the train state of a sharded `model`: a
    leaf of the params or of a moment is cut as its parameter is sharded (its
    `placements`; a leaf that stacks a segment's blocks one dim further in),
    and this rank's shard goes to the model's device; the step stays whole."""
    cuts = {}
    for key, held in interop.leaf_parameters(model).items():
        lead = int(isinstance(held, list))
        p = held[0] if lead else held
        pl = tuple(Shard(q.dim + lead) if isinstance(q, Shard) else q for q in p.placements)
        cuts[key] = (lambda whole, mesh=p.device_mesh, pl=pl:
                     local_shard(whole, mesh, pl).to(model.device))

    def fn(key: str, _tensor):
        for head in ("['params']", "['opt'].m", "['opt'].v"):
            if key.startswith(head):
                return cuts[key[len(head):]]
        return None

    return fn


def restore_state(directory: str, step: int, model: Model) -> AdamWState:
    """Restore the train state of `step`: the parameters are written into
    `model` in place, and the AdamW state comes back on the model's device;
    on a sharded model each rank keeps its shards, whatever layout wrote the
    checkpoint."""
    params = list(model.parameters())
    meta = [torch.empty(p.shape, dtype=p.dtype, device="meta") for p in params]
    f32 = [torch.empty(p.shape, dtype=torch.float32, device="meta") for p in params]
    template = state_tree(model, AdamWState(
        step=torch.zeros((), dtype=torch.int32, device="meta"), m=f32, v=f32), meta)
    sharded = isinstance(params[0], DTensor)  # shard_model makes every parameter one
    state = restore_into(directory, template, step=step, device=model.device,
                         sharding_fn=_sharding_fn(model) if sharded else None)
    with torch.no_grad():
        for p, value in zip(params, interop.tensors_from_tree(model, state["params"]),
                            strict=True):
            (p.to_local() if isinstance(p, DTensor) else p).copy_(value)
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
    the whole one does not fit a card, or one whose config carries another
    remat policy (it must live on `device` and match `tc`'s config but for
    `num_layers` and `remat_policy`, whose values it keeps; the reference's
    dry run sets the policy on the config too); by default the
    weights are drawn from `tc.seed`.  Either way, rank 0's weights are
    broadcast so every rank starts from the same ones; on a `gspmd` mesh each
    rank then keeps its shards and the whole copy is freed."""
    _check_supported(tc)
    cfg = model_config(tc)
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(tc.mesh_shape, tc.mesh_axes, dev) if tc.mesh_shape else None
    world = current_world()
    lay = layout(tc, world, mesh)
    if tc.batch_size % lay.rows.size:
        raise ValueError(f"global batch {tc.batch_size} does not split over "
                         f"{lay.rows.size} ranks")
    data = SyntheticLM(cfg.vocab_size, tc.seq_len, seed=tc.seed)

    if model is None:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(tc.seed), dev)
    elif dataclasses.replace(cfg, num_layers=model.cfg.num_layers,
                             remat_policy=model.cfg.remat_policy) != model.cfg \
            or model.device != dev:
        raise ValueError(f"model ({model.cfg.name} on {model.device}) does not match "
                         f"the run ({cfg.name} on {dev})")
    if world.size > 1:
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=0)
    if lay.sharded:
        shard_model(model, mesh)
    opt_state = adamw_init(list(model.parameters()))
    ef = (make_error_feedback_state(list(model.parameters()))
          if tc.grad_sync == "bridge-compressed" else None)
    step_fn = make_train_step(tc, lay, mesh)

    start = 0
    if tc.checkpoint_dir:
        last = latest_step(tc.checkpoint_dir)
        if last is not None:
            t0 = time.perf_counter()
            opt_state = restore_state(tc.checkpoint_dir, last, model)
            start = last
            progress(f"resumed from step {start} ({time.perf_counter() - t0:.4f} s)")

    per_rank = tc.batch_size // lay.rows.size
    rows = slice(lay.rows.rank * per_rank, (lay.rows.rank + 1) * per_rank)
    losses = []
    for step in range(start, tc.steps):
        # one stream per example: the global batch is identical for any layout
        # (the rows of this rank are cut from it)
        host_batch = data.global_batch(step, tc.batch_size, 1)
        batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in host_batch.items()}
        t0 = time.perf_counter()
        opt_state, metrics, ef = step_fn(model, opt_state, batch, ef)
        loss = float(metrics["loss"])  # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        progress(f"step {step:5d} loss {loss:.4f} "
                 f"gnorm {float(metrics['grad_norm']):.3f} dt {dt:.4f}s")
        if tc.checkpoint_dir and (step + 1) % tc.checkpoint_every == 0:
            t0 = time.perf_counter()
            if lay.sharded:  # every rank gathers, rank 0 writes
                tree = whole_state(model, opt_state, keep=world.rank == 0)
            elif world.rank == 0:
                tree = state_tree(model, opt_state)
            if world.rank == 0:
                path = save(tc.checkpoint_dir, step + 1, tree)
                progress(f"saved step {step + 1} to {path} "
                         f"({time.perf_counter() - t0:.4f} s)")
            if world.size > 1:  # no rank resumes before the step is written
                dist.barrier()
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

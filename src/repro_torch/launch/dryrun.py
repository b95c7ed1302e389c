"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell on a
fake world, with no device touched.

The counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
on 512 fake XLA host devices.  The port traces one rank's step instead:
  - `torch.distributed`'s `fake` backend at world size 256 (pod, a (16, 16)
    data x model mesh) or 512 (multipod, (2, 16, 16)), every collective a
    no-op that returns tensors of the right shape;
  - the model, the AdamW moments, the batch and the caches built under
    `FakeTensorMode` on the `cpu` device type, so the plain versions of the
    kernels are traced (the CUDA kernels are `ctypes` calls, which take no
    fake tensor), as the reference lowers its jnp attention;
  - parameters (and so their moments) placed by `launch.shardings.shard_model`
    exactly as `train()` places them on a mesh, gathered on use.

The steps (`run_step`) are the port's own: train is
`launch.train.make_train_step` (forward, remat recompute, backward, AdamW)
in `train()`'s gspmd layout (rows over the batch axes, the 'model' peers
splitting the projections: tensor parallelism); prefill is what
`models.prefill` runs (the forward in "prefill" mode, into the cell's
caches) and decode `models.decode_step` against full caches of the cell's
`seq_len`.  A serving cell traces one rank's step as `serve_requests` runs
it on a mesh: the batch rows split over `batch_axes(mesh)` (whole on every
rank where they do not divide), the projections split over 'model', and
the caches held as `cache_shardings` lays them out: a leaf whose 'model'
shard is what the block computes (the local KV heads where they divide) is
that plain local tensor; a leaf sharded otherwise (the MLA latent's
sequence, `kv-seq-sharded`, the odd 'data' of `slot_pos`) is a DTensor
shard that the block gathers where it reads the cache, and a leaf the block
computes a part of but the rule keeps whole or shards otherwise (RG-LRU
states, KV heads that do not divide) is cut to the block's part and its
update gathered back over 'model' (`models.sharding`, inside
`activation_sharding(..., sharded_caches=True)`).

The variants are the reference's:
  serve-tp-params : `param_shardings(..., fsdp=False)`;
  moe-ep-data     : `moe_expert_axis="data"`: the expert stacks stay sharded
                    over 'data', and the MoE exchanges tokens over 'data';
  kv-seq-sharded  : `cache_shardings(kv_seq_shard=True)`: a rank holds 1/16
                    of the sequence and gathers the shards over 'model' where
                    attention reads the cache (GSPMD would instead insert a
                    partial-softmax combine; the port's choice differs);
  logits-sharded  : the vocab-parallel logits are not gathered, so the
                    decode logits stay (B_local, V / 16) (where V divides);
  seq-parallel    : traced as the baseline: the port keeps the sequence
                    whole (`models.sharding` reads only whether a rule is
                    set), and the cell's JSON says so (`seq_parallel_note`);
  remat-dots, remat-none, moe-vmap : the config tweaks.

What a cell records (the reference's keys where they mean the same):
  flops       : one rank's FLOPs of the matrix products (`FlopCounterMode`:
                `mm`, `bmm` and their `out_dtype` overloads, the einsums they
                lower to), of ONE pattern period of layers (the 1-period
                trace), as the reference's are a scan body counted once;
  collectives : {op kind: {bytes, count}} and `total_bytes` under the
                reference's five names, counted by `CollectiveCounter` (the
                functional collectives of DTensor's gathers and gradient
                reductions, the c10d ops the port's `collectives/` issue);
                bytes are each op's result bytes; also of the 1-period trace;
  memory      : the bytes a rank holds at full depth (parameters, AdamW
                moments, caches, batch, summed from the local shards) and a
                peak estimate (`MemTracker` under the fake mode, 1 and 2
                periods extrapolated as below) beside the card's 80 GB;
  calibrated  : the reference's `calibrate_depth`: P = X(2p) - X(p),
                X(p) + P (L / p - 1), of flops, collective bytes and the peak.
                An eager trace counts every layer, so a full-depth trace
                would need no calibration; the periods bound the trace time
                (the plain WKV-6 and RG-LRU are T-step Python loops).
The peak is traced on the CPU path, where a bf16 product casts its operands
to float32 (the card's `mm(..., out_dtype=float32)` does not): an
over-estimate by the largest such copy, reported, not gated.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
More than one cell to trace runs one worker process a core (a cell holds
one), at most one a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.data import make_batch_specs
from repro_torch.models import SHAPES, forward, init_caches, init_params
from repro_torch.models.model import cache_cuts
from repro_torch.models.sharding import TokenSplit, activation_sharding
from repro_torch.optim import adamw_init

from .mesh import axis_sizes, batch_axes, make_production_mesh
from .shardings import (activation_rules, cache_shardings, distribute, local_shard, placements,
                        shard_model)
from .train import TrainConfig, current_world, layout, make_train_step

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
VARIANTS = ("baseline", "logits-sharded", "moe-ep-data", "remat-dots",
            "remat-none", "kv-seq-sharded", "moe-vmap", "serve-tp-params",
            "seq-parallel")
CARD_BYTES = 80e9   # an H100's 80 GB of HBM


# --- collective accounting -----------------------------------------------------


# op name (c10d's in-place ops and the functional collectives) -> kind
_KINDS = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    # a shift is one send and one receive: counted once, at the receive
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}
_UNCOUNTED = {"send", "wait_tensor", "barrier"}
_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched under it by the reference's five
    kinds, with each op's result bytes: the functional collectives' outputs,
    the c10d ops' output buffers (their first argument).  A collective of a
    kind it does not know raises, so none goes uncounted."""

    def __init__(self):
        super().__init__()
        self.ops = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _NAMESPACES and func._opname not in _UNCOUNTED:
            kind = _KINDS.get(func._opname)
            if kind is None:
                raise ValueError(f"uncounted collective {func.name()}")
            self.ops[kind]["bytes"] += _bytes(out if func.namespace != "c10d" else args[0])
            self.ops[kind]["count"] += 1
        return out

    def result(self) -> dict:
        out = {k: dict(v) for k, v in self.ops.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.ops.values())
        return out


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """2 b m n k: `bmm`'s formula, taking the `out_dtype` overload's extra
    argument, which the library's formula mistakes for its output shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def flop_counter() -> FlopCounterMode:
    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop})


# --- the fake world ------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(mesh_kind: str):
    """A world of 256 (pod) or 512 (multipod) ranks on the `fake` backend,
    this process rank 0, and the production mesh over it; torn down on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("the dry run sets up its own world: a process group exists")
    multi_pod = mesh_kind == "multipod"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


def _apply_variant(cfg, variant: str):
    tweaks = {v.strip() for v in variant.split(",") if v.strip()}
    unknown = tweaks - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variant(s) {unknown}; known: {VARIANTS}")
    if "remat-dots" in tweaks:
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    if "remat-none" in tweaks:
        cfg = dataclasses.replace(cfg, remat_policy="none")
    if "moe-vmap" in tweaks and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, vectorize_groups=True,
                                         group_size=128))
    return cfg, tweaks


# --- one rank's state ------------------------------------------------------------------


def _tree_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors: a DTensor's local shard."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _bytes(tree.to_local())
    return _bytes(tree)


def _serving_rows(mesh, batch: int):
    """(rows, group) of a serving cell: the batch rows split over the batch
    axes where they divide (the group of ranks holding distinct rows), else
    every row on every rank (a group of this rank alone)."""
    axes = batch_axes(mesh)
    n = math.prod(axis_sizes(mesh)[a] for a in axes)
    if batch % n:
        return batch, dist.new_group([dist.get_rank()])
    sub = mesh[axes] if len(axes) == 1 else mesh[axes]._flatten()
    return batch // n, sub.get_group()


def _shard_caches(caches: list[dict], cfg, mesh, global_batch: int, kv_seq_shard: bool):
    """Each cache leaf (whole, its rows already this rank's) as
    `cache_shardings` lays out the reference's stacked leaf (1, B, ...): the
    batch entry is the rows; a leaf whose only other sharded dim is the one
    the block cuts over 'model', evenly (`models.model.cache_cuts`), is this
    rank's part, a plain tensor; any other sharded leaf a DTensor shard.
    `slot_pos` (S,) has no batch dim; the rule's heuristic shards its S over
    the batch axes."""
    tp = axis_sizes(mesh).get("model", 1)
    names = list(axis_sizes(mesh))

    def one(key, t, cut):
        if not isinstance(t, torch.Tensor):
            return t
        shape = ((1, *t.shape) if key.endswith("slot_pos")
                 else (1, global_batch, *t.shape[1:]))
        spec = cache_shardings(mesh, {key: shape}, kv_seq_shard=kv_seq_shard)[key][1:]
        if not key.endswith("slot_pos"):
            spec = (None, *spec[1:])
        if all(ax is None for ax in spec):
            return t
        pl = placements(mesh, spec)
        even = cut is not None and cut[1] == [
            list(range(r * t.shape[cut[0]] // tp, (r + 1) * t.shape[cut[0]] // tp))
            for r in range(tp)]
        if even and [ax for ax in spec if ax is not None] == ["model"] \
                and pl[names.index("model")].dim == cut[0]:
            return local_shard(t, mesh, pl)     # the block's own part
        return distribute(t, mesh, pl)

    def walk(c, cuts, prefix=""):
        return {k: walk(v, cuts, f"{prefix}{k}.") if isinstance(v, dict)
                else one(f"{prefix}{k}", v, cuts.get(f"{prefix}{k}"))
                for k, v in c.items()}

    return [walk(c, cache_cuts(cfg, kind, tp, cfg.enc_dec))
            for c, kind in zip(caches, cfg.layer_kinds, strict=True)]


def _fill(caches: list[dict], seq_len: int) -> None:
    """Full caches: decode writes the last position (a fake tensor holds no
    values, so the positions are all there is to set)."""
    for c in caches:
        if "pos" in c["mix"]:
            c["mix"]["pos"] = seq_len - 1


@dataclasses.dataclass
class Rank:
    """One rank's state for a cell: the sharded model and what its step reads."""

    model: object
    mode: str
    batch: dict
    split: TokenSplit | None
    opt_state: object = None
    caches: list | None = None
    step_fn: object = None
    mesh: object = None

    def held(self) -> dict:
        out = {"params_bytes": _tree_bytes(list(self.model.parameters())),
               "opt_bytes": 0 if self.opt_state is None else
               _tree_bytes([self.opt_state.step, *self.opt_state.m, *self.opt_state.v]),
               "cache_bytes": 0 if self.caches is None else _tree_bytes(self.caches),
               "batch_bytes": _tree_bytes(self.batch)}
        out["held_bytes"] = sum(out.values())
        return out


def _split(shape, mesh, tweaks: set):
    """(train's Layout or None, this rank's TokenSplit) of a cell: outside
    the fake mode, since it may make process groups."""
    experts = mesh.get_group("data" if "moe-ep-data" in tweaks else "model")
    if shape.mode == "train":
        tc = TrainConfig(batch_size=shape.global_batch, grad_sync="gspmd")
        lay = layout(tc, current_world(), mesh)
        lay = dataclasses.replace(lay, split=dataclasses.replace(lay.split, experts=experts))
        return lay, lay.split
    rows, group = _serving_rows(mesh, shape.global_batch)
    model = mesh.get_group("model")
    return None, TokenSplit(rows, group, experts, model if dist.get_world_size(model) > 1 else None)


def build_rank(cfg, shape, mesh, tweaks: set, lay, split: TokenSplit) -> Rank:
    """One rank's model, optimizer state, batch and caches for a cell.  Call
    under a `FakeTensorMode` on a fake world: nothing is allocated."""
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shard_model(model, mesh, moe_expert_axis="data" if "moe-ep-data" in tweaks else "model",
                fsdp="serve-tp-params" not in tweaks)
    if shape.mode == "train":
        tc = TrainConfig(batch_size=shape.global_batch, grad_sync="gspmd")
        step = make_train_step(tc, lay, mesh)
        rank = Rank(model, "train", {}, split, adamw_init(list(model.parameters())),
                    step_fn=step, mesh=mesh)
    else:
        caches = _shard_caches(init_caches(cfg, split.rows, shape.seq_len, "cpu"), cfg, mesh,
                               shape.global_batch, "kv-seq-sharded" in tweaks)
        if shape.mode == "decode":
            _fill(caches, shape.seq_len)
        rank = Rank(model, shape.mode, {}, split, caches=caches, mesh=mesh)
    rank.batch = {k: torch.zeros((split.rows, *s[1:]), dtype=dt)
                  for k, (s, dt) in make_batch_specs(cfg, shape).items()}
    return rank


def run_step(rank: Rank, cfg, shape, tweaks: set):
    """The cell's step, once, on `rank`'s state."""
    if rank.mode == "train":
        return rank.step_fn(rank.model, rank.opt_state, rank.batch)
    with torch.no_grad(), activation_sharding(rank.mesh, activation_rules(rank.mesh),
                                              rank.split, sharded_caches=True):
        # `models.prefill`, into the sharded caches; `models.decode_step`
        out = forward(cfg, rank.model, rank.batch, caches=rank.caches, mode=rank.mode,
                      logits_whole="logits-sharded" not in tweaks)
        return out.logits[:, -1, :], out.caches


def trace_step(cfg, shape, mesh, variant: str = "baseline") -> dict:
    """Trace one step of `cfg` (at its own depth) on the fake world of
    `mesh`: {"flops", "collectives", "peak_bytes", "logits_shape"}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg, tweaks = _apply_variant(cfg, variant)
    lay, split = _split(shape, mesh, tweaks)
    with FakeTensorMode():
        rank = build_rank(cfg, shape, mesh, tweaks, lay, split)
        tracker = MemTracker()
        tracker.track_external(rank.model, *[t for t in _leaves(rank) if t is not None])
        counter, flops = CollectiveCounter(), flop_counter()
        with tracker, flops, counter:
            out = run_step(rank, cfg, shape, tweaks)
        peak = tracker.get_tracker_snapshot("peak")
    logits = out[0] if rank.mode != "train" else None
    return {"flops": flops.get_total_flops(), "collectives": counter.result(),
            "peak_bytes": max(v["Total"] for v in peak.values()),
            "logits_shape": None if logits is None else list(logits.shape)}


def _leaves(rank: Rank) -> list:
    out = list(rank.batch.values())
    if rank.opt_state is not None:
        out += [rank.opt_state.step, *rank.opt_state.m, *rank.opt_state.v]

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, torch.Tensor):
            out.append(tree.to_local() if isinstance(tree, DTensor) else tree)

    for c in rank.caches or []:
        walk(c)
    return out


def held_state(cfg, shape, mesh, variant: str = "baseline") -> dict:
    """The bytes one rank holds for a cell at `cfg`'s depth (no step run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, tweaks = _apply_variant(cfg, variant)
    lay, split = _split(shape, mesh, tweaks)
    with FakeTensorMode():
        return build_rank(cfg, shape, mesh, tweaks, lay, split).held()


# --- cell runner ----------------------------------------------------------------------


def periods(cfg, k: int):
    """`cfg` cut to k pattern periods (and whisper's encoder in proportion)."""
    p = len(cfg.pattern)
    factor = cfg.num_layers / p
    enc = max(1, round(cfg.num_encoder_layers / factor)) if cfg.enc_dec else 0
    return dataclasses.replace(cfg, num_layers=k * p, num_encoder_layers=k * enc)


def calibrate_depth(cfg, shape, mesh, variant: str = "baseline") -> tuple[dict, dict]:
    """The reference's per-layer recovery: trace 1 and 2 pattern periods,
    P = X(2p) - X(p), X(p) + P (L / p - 1).  Returns (the 1-period trace,
    the calibrated values)."""
    factor = cfg.num_layers / len(cfg.pattern)
    m1 = trace_step(periods(cfg, 1), shape, mesh, variant)
    m2 = trace_step(periods(cfg, 2), shape, mesh, variant)
    out, per = {}, {}
    for k, get in (("flops", lambda m: m["flops"]),
                   ("collective_bytes", lambda m: m["collectives"]["total_bytes"]),
                   ("peak_bytes", lambda m: m["peak_bytes"])):
        per[k] = get(m2) - get(m1)
        out[k] = get(m1) + max(0, per[k]) * (factor - 1)
    out["per_period"] = per
    return m1, out


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline") -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    with fake_world(mesh_kind) as mesh:
        m1, calibrated = calibrate_depth(cfg, shape, mesh, variant)
        memory = held_state(cfg, shape, mesh, variant)
        devices = dist.get_world_size()
    memory["peak_bytes"] = calibrated["peak_bytes"]
    memory["card_bytes"] = CARD_BYTES
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
        "devices": devices, "mode": shape.mode,
        "trace_seconds": round(time.perf_counter() - t0, 1),
        "traced_layers": periods(cfg, 1).num_layers,
        "flops": m1["flops"], "collectives": m1["collectives"],
        "memory": memory,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "calibrated": calibrated,
    }
    if m1["logits_shape"] is not None:
        result["logits_shape"] = m1["logits_shape"]
    if "kv-seq-sharded" in variant:
        result["kv_seq_note"] = ("each rank holds 1/16 of the sequence and gathers the "
                                 "shards over 'model' where attention reads the cache; "
                                 "GSPMD would insert a partial-softmax combine")
    if "seq-parallel" in variant:
        result["seq_parallel_note"] = ("traced as the baseline: the port keeps the sequence "
                                       "whole, where the reference shards the block outputs' "
                                       "sequence over 'model'")
    return result


def _run_tagged(job: tuple) -> tuple:
    """One cell of the sweep, in a worker process: (tag, status, result)."""
    arch, shp, mk, variant, tag = job
    try:
        return tag, "OK", run_cell(arch, shp, mk, variant=variant)
    except Exception as e:  # a failing cell is recorded, the sweep goes on
        return tag, "FAIL", {"arch": arch, "shape": shp, "mesh": mk, "variant": variant,
                             "error": f"{type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="baseline",
                    help="comma-separated tweaks: " + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    _apply_variant(configs.get("stablelm-3b"), args.variant)  # a bad name fails first

    cells: list[tuple[str, str]] = []
    if args.all:
        for a, s in configs.cells():
            ok, why = configs.runnable(a, s)
            if ok:
                cells.append((a, s))
            else:
                print(f"SKIP {a} x {s}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    jobs = []
    for arch, shp in cells:
        for mk in meshes:
            tag = f"{arch}__{shp}__{mk}"
            if args.variant != "baseline":
                tag += "__" + args.variant.replace(",", "+")
            if os.path.exists(os.path.join(args.out, tag + ".json")):
                print(f"CACHED {tag}")
                continue
            jobs.append((arch, shp, mk, args.variant, tag))
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        import multiprocessing

        for job in jobs:
            print(f"RUN {job[-1]} ...", flush=True)
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            for tag, status, res in pool.imap_unordered(_run_tagged, jobs):
                _record(args.out, tag, status, res)
    else:
        for job in jobs:
            print(f"RUN {job[-1]} ...", flush=True)
            _record(args.out, *_run_tagged(job))


def _record(out: str, tag: str, status: str, res: dict) -> None:
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    if status == "OK":
        mem = res["memory"]
        extra = (f" flops={res['flops']:.3g}"
                 f" coll={res['collectives']['total_bytes']:.3g}B"
                 f" held={mem['held_bytes'] / 1e9:.2f}GB"
                 f" peak~{mem['peak_bytes'] / 1e9:.2f}GB of {CARD_BYTES / 1e9:.0f}GB"
                 f" trace={res['trace_seconds']}s")
    else:
        extra = f" {res['error'][:200]}"
    print(f"{status} {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()

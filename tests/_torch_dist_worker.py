"""Multi-process checks of the port over `torch.distributed` with gloo (CPU).

One process per rank: `python tests/_torch_dist_worker.py MODE RANK WORLD PORT
[ARGS]`.  `spawn` starts all ranks on a free localhost port and fails at a
time limit rather than hanging.  Imports no JAX.

Modes:
  collectives       the port of tests/_multidevice_worker.py's RS / AG /
                    all-reduce checks, against NumPy sums; prints 'ok <name>'
                    per check and 'ALL-OK'.
  a2a IN OUT        bruck_all_to_all of row `rank` of the (n, n, ...) array
                    in the .npy file IN; each rank writes its output to
                    OUT.<rank>.npy.
  compressed OUT    two rounds of compressed_all_reduce (the second with the
                    first's error feedback) on two seeded gradient leaves
                    per rank; rank 0 writes both rounds' sums and every
                    rank's inputs to the .npz file OUT.
  train PARAMS OUT [MODE ...]
                    trains stablelm-3b smoke (4 steps, batch 8, seq 32) with
                    each grad_sync MODE in turn (default: gspmd, then
                    bridge), from the weights in the .npz file PARAMS (JAX
                    tree layout, flattened); rank 0 writes the loss lists,
                    by mode, to the JSON file OUT.
  restart DIR OUT   trains stablelm-3b smoke (bridge) 4 steps straight, then
                    2 steps with a checkpoint into DIR and 4 steps resumed
                    from it; rank 0 writes the three loss lists and each
                    rank's progress lines to the JSON file OUT.
  mesh PARAMS OUT ARCH STEPS BATCH SEQ RUN ...
                    trains ARCH smoke (STEPS steps, global batch BATCH x SEQ)
                    once per RUN, `MODE@SHAPE` (`gspmd@2x2`: a (2, 2)
                    ("data", "model") mesh, `gspmd@4`: a (4,) ("data",) one,
                    `gspmd@-`: no mesh), from the weights in the .npz file
                    PARAMS (or drawn from the seed where PARAMS is `-`);
                    rank 0 writes {run: losses} to the JSON file OUT and each
                    run's final parameters, whole, in the JAX tree layout to
                    OUT.<run>.npz.  On a mesh it checks that every parameter
                    and moment is a shard of the rule table's placements.
  elastic DIR OUT [JAXDIR]
                    check 5 of tests/_distributed_worker.py on stablelm-3b
                    smoke: 2 gspmd steps on a (4,) mesh saving into DIR, then
                    steps 3-4 resumed on a (2, 2) mesh, and 4 straight steps
                    on (4,); with JAXDIR (a JAX checkpoint of step 2) it also
                    resumes that one on (2, 2).  Rank 0 writes the loss lists
                    to the JSON file OUT.
  spans OUT         `collectives.shift`'s counters over ring_all_reduce and
                    bruck_all_reduce of a (7, 11) f32 and a (5,) bf16 leaf,
                    and one bridge training step of stablelm-3b smoke
                    (batch 2 a rank, seq 16) under the CPU profiler: its
                    `train.*` spans, `step.shifts`, `step.phase_seconds()`
                    and its parameters' sizes; rank 0 writes them to the
                    JSON file OUT.
  a2a_grad OUT      the differentiable bruck_all_to_all on a seeded (n, 3, 5)
                    input per rank: its output against dist.all_to_all_single
                    and the gradient of sum(out * w) against the plain
                    transpose; rank 0 writes every rank's arrays to OUT.npz.
  adamw OUT         adamw_update on DTensor shards over a (2, 2) mesh (leaves
                    sharded on both axes, on one, replicated; gradients large
                    enough to clip), 2 steps, against adamw_update on the
                    whole tensors; rank 0 writes both to OUT.npz.
  tp DIR OUT SHAPE NAME ...
                    tensor parallelism on a SHAPE (`1x2`, `2x2`, `1x4`)
                    ("data", "model") mesh, for each case NAME: the port
                    config DIR/NAME.json, the JAX-layout weights
                    DIR/NAME.npz and the batch DIR/NAME.batch.npz.  The
                    forward logits of the whole batch; the loss and every
                    gradient (whole) in `train()`'s layout; whether every
                    gradient replicated over 'model' is bit-equal across the
                    'model' peers; served ids (`serve_requests`, or prefill
                    and greedy decode steps where the batch has frames or
                    patches) from the serving layout (fsdp=False), with the
                    cache shapes after prefill and every rank's ids; and on
                    (2, 2) 2 `train()` steps, after which every parameter
                    replicated over 'model' must be bit-equal across the
                    peers; the sharded init against `shard_model` of the
                    whole one.  Rank 0 writes OUT.NAME.npz and OUT.NAME.json.
  tp64 DIR OUT SHAPE NAME
                    the loss and every gradient of case NAME (as `tp`) in
                    float64: every `.float()` of the model taken as
                    `.double()`, the WKV-6 op differentiated through its
                    plain scan, the weights and the config's dtype float64;
                    on the SHAPE mesh in `train()`'s layout and, on rank 0,
                    on the whole batch without a mesh.  Rank 0 writes
                    OUT.NAME.npz (`tp/` and `one/` gradients) and
                    OUT.NAME.json (both losses).
  sp DIR OUT SHAPE  sequence parallelism and the rest of the 'model' axis on a
                    SHAPE ("data", "model") mesh, the cases named by the JSON
                    file DIR/plan.json ({"sp": [...], "combine": [...],
                    "ep": [...]}; each case's files as `tp`'s).  "sp": the
                    forward logits, and the loss and every gradient (whole)
                    in `train()`'s layout under the `seq-parallel` rule, for
                    the batch and for its first S - 1 positions (a sequence
                    that does not divide), with the collectives each issued
                    (the dry run's counter), whether every gradient replicated
                    over 'model' is bit-equal across the peers, and whether
                    the unembedding is vocab-split.  "combine": the dry
                    run's sharded serving layout (its `_split` and
                    `_shard_caches`, the `_serve` field's variant) with real
                    tensors: prefill and greedy decode steps, the logits of
                    every row, and the cache leaves held as their
                    sequence's 'model' shard.  "ep": the loss and every
                    gradient with `moe_expert_axis="data"` (tensor
                    parallelism inside the experts), which expert stacks
                    keep d_ff over 'model'.  Also the vocab-parallel loss
                    and argmax against their whole-vocab versions on seeded
                    logits.  Rank 0 writes OUT.NAME.npz and OUT.NAME.json a
                    case ("ep-NAME" for an "ep" case), and OUT.vocab.json.
  tp_restart DIR OUT
                    stablelm-3b smoke under tensor parallelism: 2 gspmd steps
                    on (1, 2) saving into DIR, steps 3-4 resumed on (2, 1),
                    and 4 straight steps on (1, 2); rank 0 writes the loss
                    lists to the JSON file OUT.
  pipeline IN OUT N_MICRO
                    run_pipeline of the reference's tanh stages on a (world,)
                    ("pod",) mesh, stage weights and input from the .npz file
                    IN, N_MICRO microbatches; rank 0 writes the pipeline's
                    output and the port's sequential run of the same
                    microbatches to the .npz file OUT.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, world: int, *args: str, timeout: float = 120.0) -> list[str]:
    """Run `world` ranks of this worker; returns each rank's stdout.  Raises
    AssertionError if a rank fails or the run passes `timeout` seconds (every
    rank is killed then)."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), port,
                               *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        raise AssertionError(f"{mode} on {world} gloo ranks passed its {timeout} s "
                             f"limit") from None
    for r, (proc, out) in enumerate(zip(procs, outs, strict=True)):
        assert proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n{out}"
    return outs


def _collectives(n: int, rank: int) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import (bridge_all_reduce, bruck_all_gather,
                                         bruck_all_reduce, bruck_reduce_scatter,
                                         ring_all_gather, ring_all_reduce,
                                         ring_reduce_scatter)
    from repro_torch.core.cost_model import PAPER_DEFAULT
    from repro_torch.planner import PlanRequest, default_planner

    rng = np.random.default_rng(0)  # every rank draws the same global arrays

    def check(name, got, want):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0, err_msg=name)
        if rank == 0:
            print("ok", name, flush=True)

    def schedule(kind, m_bytes):
        return default_planner().plan(PlanRequest(
            kind=kind, n=n, m_bytes=m_bytes, cost_model=PAPER_DEFAULT)).schedule

    # reduce-scatter: rank j's contribution x[j] (n, 6); block i of the sum at rank i
    x = rng.standard_normal((n, n, 6)).astype(np.float32)
    want = x.sum(axis=0)[rank]
    mine = torch.from_numpy(x[rank])
    check("bruck_reduce_scatter", bruck_reduce_scatter(mine), want)
    check("ring_reduce_scatter", ring_reduce_scatter(mine), want)
    if n > 1:  # the planner plans for two ranks or more
        check("bruck_reduce_scatter(schedule)",
              bruck_reduce_scatter(mine, schedule("rs", 6 * 4.0)), want)

    # all-gather: rank p's block x[p] (5,); every rank gets all n blocks
    x = rng.standard_normal((n, 5)).astype(np.float32)
    mine = torch.from_numpy(x[rank])
    check("bruck_all_gather", bruck_all_gather(mine), x)
    check("ring_all_gather", ring_all_gather(mine), x)
    if n > 1:
        check("bruck_all_gather(schedule)", bruck_all_gather(mine, schedule("ag", 5 * 4.0)), x)

    # all-reduce on a (7, 11) tensor, deliberately not divisible by n
    x = rng.standard_normal((n, 7, 11)).astype(np.float32)
    want = x.sum(axis=0)
    mine = torch.from_numpy(x[rank])
    check("ring_all_reduce", ring_all_reduce(mine), want)
    check("bruck_all_reduce", bruck_all_reduce(mine), want)
    check("bridge_all_reduce", bridge_all_reduce(mine, PAPER_DEFAULT), want)
    if rank == 0:
        print("ALL-OK", flush=True)


def _a2a(n: int, rank: int, in_path: str, out_path: str) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import bruck_all_to_all

    x = torch.from_numpy(np.load(in_path)[rank])
    np.save(f"{out_path}.{rank}.npy", bruck_all_to_all(x).numpy())


def _compressed(n: int, rank: int, out_path: str) -> None:
    import numpy as np
    import torch

    from repro_torch.collectives import compressed_all_reduce, make_error_feedback_state

    rng = np.random.default_rng(0)  # every rank draws the same global arrays
    glob = [rng.standard_normal((n, 33)).astype(np.float32) * 3.0,
            rng.standard_normal((n, 4, 5)).astype(np.float32)]
    grads = [torch.from_numpy(g[rank]) for g in glob]
    ef = make_error_feedback_state(grads)
    out1, ef = compressed_all_reduce(grads, ef)
    # second round on the same grads: error feedback corrects round-1 error
    out2, _ = compressed_all_reduce(grads, ef)
    if rank == 0:
        np.savez(out_path, **{f"g{i}": g for i, g in enumerate(glob)},
                 **{f"round1_{i}": t.numpy() for i, t in enumerate(out1)},
                 **{f"round2_{i}": t.numpy() for i, t in enumerate(out2)})
    torch.distributed.barrier()


def _load_tree(params_path: str) -> dict:
    """The JAX-layout tree flattened into the .npz file `params_path`."""
    import numpy as np

    flat = np.load(params_path)
    tree: dict = {}
    for key in flat.files:  # "a/b/c" -> tree["a"]["b"]["c"]; list indices as ints
        node, parts = tree, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _train(n: int, rank: int, params_path: str, out_path: str, *modes: str) -> None:
    import torch

    from repro_torch.interop import params_from_jax
    from repro_torch.launch.train import TrainConfig, model_config, train

    tree = _load_tree(params_path)
    kw = {"arch": "stablelm-3b", "steps": 4, "batch_size": 8, "seq_len": 32}
    losses = {}
    for mode in modes or ("gspmd", "bridge"):
        tc = TrainConfig(grad_sync=mode, **kw)
        model = params_from_jax(model_config(tc), tree, device="cpu")
        _, _, losses[mode] = train(tc, progress=lambda *_: None, device="cpu", model=model)
    if rank == 0:
        Path(out_path).write_text(json.dumps(losses))
    torch.distributed.barrier()


def _restart(n: int, rank: int, ckpt_dir: str, out_path: str) -> None:
    import torch

    from repro_torch.launch.train import TrainConfig, train

    kw = {"arch": "stablelm-3b", "batch_size": 8, "seq_len": 32, "grad_sync": "bridge"}
    runs, lines = {}, []
    for name, tc in (("straight", TrainConfig(steps=4, **kw)),
                     ("first", TrainConfig(steps=2, checkpoint_dir=ckpt_dir, checkpoint_every=2,
                                           **kw)),
                     ("resumed", TrainConfig(steps=4, checkpoint_dir=ckpt_dir, **kw))):
        _, _, runs[name] = train(tc, progress=lines.append, device="cpu")
    gathered = [None] * n
    torch.distributed.all_gather_object(gathered, lines)
    if rank == 0:
        Path(out_path).write_text(json.dumps({**runs, "lines": gathered}))
    torch.distributed.barrier()


def _flat(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": tensor} of a JAX-layout tree (as `_torch_parity.flatten`)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _mesh_of(shape: str) -> dict:
    """TrainConfig's mesh fields of a RUN's SHAPE: `2x2`, `4` or `-`."""
    if shape == "-":
        return {}
    dims = tuple(int(d) for d in shape.split("x"))
    return {"mesh_shape": dims, "mesh_axes": ("data", "model")[:len(dims)]}


def _check_shards(model, opt_state) -> None:
    """Every parameter a DTensor of the rule table's placements, its moments
    of the shard's shape."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import param_shardings, placements

    mesh = next(model.parameters()).device_mesh
    specs = param_shardings(mesh, model)
    for (name, p), m, v in zip(model.named_parameters(), opt_state.m, opt_state.v,
                               strict=True):
        assert isinstance(p, DTensor), name
        assert tuple(p.placements) == placements(mesh, specs[name]), (name, p.placements)
        assert m.shape == v.shape == p.to_local().shape, name


def _mesh(n: int, rank: int, params_path: str, out_path: str, arch: str, steps: str,
          batch: str, seq: str, *runs: str) -> None:
    import numpy as np
    import torch

    from repro_torch.interop import params_from_jax, tree_from_tensors
    from repro_torch.launch.train import TrainConfig, model_config, train

    tree = None if params_path == "-" else _load_tree(params_path)
    out = {}
    for run in runs:  # MODE@SHAPE, or MODE@SHAPE@POLICY: the model's remat policy
        mode, shape, *policy = run.split("@")
        tc = TrainConfig(arch=arch, steps=int(steps), batch_size=int(batch),
                         seq_len=int(seq), grad_sync=mode, **_mesh_of(shape))
        cfg = model_config(tc)
        if policy:
            assert tree is not None, "a remat policy is set on converted weights"
            cfg = dataclasses.replace(cfg, remat_policy=policy[0])
        model = None if tree is None else params_from_jax(cfg, tree, device="cpu")
        model, opt_state, out[run] = train(tc, progress=lambda *_: None, device="cpu",
                                           model=model)
        if tc.mesh_shape and mode == "gspmd":
            from repro_torch.launch.train import whole_state

            _check_shards(model, opt_state)
            state = whole_state(model, opt_state, keep=rank == 0)["params"]
        else:
            state = tree_from_tensors(model, [p.detach() for p in model.parameters()])
        if rank == 0:
            np.savez(f"{out_path}.{run}.npz",
                     **{k: v.float().numpy() for k, v in _flat(state).items()})
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))
    torch.distributed.barrier()


def _elastic(n: int, rank: int, ckpt_dir: str, out_path: str, jax_dir: str = "") -> None:
    import torch

    from repro_torch.launch.train import TrainConfig, train

    kw = {"arch": "stablelm-3b", "batch_size": 8, "seq_len": 32}
    flat, square = {"mesh_shape": (4,), "mesh_axes": ("data",)}, \
        {"mesh_shape": (2, 2), "mesh_axes": ("data", "model")}
    runs = {}
    for name, tc in (("first", TrainConfig(steps=2, checkpoint_dir=ckpt_dir, checkpoint_every=2,
                                           **flat, **kw)),
                     ("resumed", TrainConfig(steps=4, checkpoint_dir=ckpt_dir,
                                             checkpoint_every=2, **square, **kw)),
                     ("straight", TrainConfig(steps=4, **flat, **kw))):
        _, _, runs[name] = train(tc, progress=lambda *_: None, device="cpu")
    if jax_dir:
        _, _, runs["from_jax"] = train(TrainConfig(steps=4, checkpoint_dir=jax_dir,
                                                   checkpoint_every=2, **square, **kw),
                                       progress=lambda *_: None, device="cpu")
    if rank == 0:
        Path(out_path).write_text(json.dumps(runs))
    torch.distributed.barrier()


def _tp_inputs(data_dir: str, name: str):
    """Case NAME of the `tp` modes: (its port config, `_serve` fields, weights
    tree, batch of tensors)."""
    import numpy as np
    import torch

    from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

    fields = json.loads(Path(data_dir, f"{name}.json").read_text())
    extra = fields.pop("_serve")
    for key, cls in (("moe", MoEConfig), ("mla", MLAConfig)):
        if fields[key] is not None:
            fields[key] = cls(**fields[key])
    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    tree = _load_tree(str(Path(data_dir, f"{name}.npz")))
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(Path(data_dir, f"{name}.batch.npz")).items()}
    return cfg, extra, tree, batch


def _tp_config(shape, batch):
    from repro_torch.launch.train import TrainConfig

    return TrainConfig(batch_size=batch["tokens"].shape[0], grad_sync="gspmd",
                       mesh_shape=shape, mesh_axes=("data", "model"))


def _tp_grads(mesh, tc, cfg, model, batch, seq_parallel=False, experts=None):
    """The loss facts (loss, nll, aux) and every gradient, whole, of the
    sharded `model` in `train()`'s layout (gspmd, `tc`) on `mesh`, under
    the `seq-parallel` rule where `seq_parallel`, the experts' exchange over
    the mesh axis `experts` where given: (facts, gradients in
    `model.parameters()` order, the layout)."""
    import torch.distributed as dist

    from repro_torch.launch.shardings import activation_rules
    from repro_torch.launch.train import current_world, layout
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import activation_sharding

    b = batch["tokens"].shape[0]
    lay = layout(tc, current_world(), mesh)
    if experts is not None:
        lay = dataclasses.replace(lay, split=dataclasses.replace(
            lay.split, experts=mesh.get_group(experts)))
    per = b // lay.rows.size
    rows = {k: v[lay.rows.rank * per:(lay.rows.rank + 1) * per] for k, v in batch.items()}
    with activation_sharding(mesh, activation_rules(mesh, seq_parallel), lay.split):
        loss, metrics = loss_fn(cfg, model, rows)
        loss.backward()
    facts = {}
    for key, value in (("loss", loss), ("nll", metrics["nll"]), ("aux", metrics["aux"])):
        value = value.detach().clone()
        dist.all_reduce(value, group=lay.rows.group)
        facts[key] = value.item() / lay.rows.size
    return facts, [p.grad.full_tensor() / lay.rows.size for p in model.parameters()], lay


def _tp_case(mesh, shape, name: str, data_dir: str):
    """One case of the `tp` mode on every rank: (arrays, facts) for rank 0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.interop import params_from_jax, tree_from_tensors
    from repro_torch.launch.serve import Request, serve_requests
    from repro_torch.launch.shardings import activation_rules, shard_model
    from repro_torch.launch.train import train
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.sharding import activation_sharding

    cfg, extra, tree, batch = _tp_inputs(data_dir, name)
    rules = activation_rules(mesh)
    model_group = mesh.get_group("model")
    arrays = {}

    model = params_from_jax(cfg, tree, device="cpu")
    shard_model(model, mesh)
    with torch.no_grad(), activation_sharding(mesh, rules):
        arrays["logits"] = forward(cfg, model, batch, mode="train").logits.numpy()
    tc = _tp_config(shape, batch)
    facts, grads, lay = _tp_grads(mesh, tc, cfg, model, batch)
    params = list(model.parameters())
    b = batch["tokens"].shape[0]
    model_dim = list(mesh.mesh_dim_names).index("model")

    def equal_over_model(tensors):
        unequal = []
        for (pname, p), t in zip(model.named_parameters(), tensors, strict=True):
            if not isinstance(p.placements[model_dim], Replicate):
                continue
            t = t.to_local() if hasattr(t, "to_local") else t
            peers = [torch.empty_like(t) for _ in range(dist.get_world_size(model_group))]
            dist.all_gather(peers, t.contiguous(), group=model_group)
            if not all(torch.equal(peers[0], x) for x in peers):
                unequal.append(pname)
        return unequal

    facts["grads_unequal"] = equal_over_model([p.grad for p in params])
    arrays |= {f"grad/{k}": v.numpy() for k, v in
               _flat(tree_from_tensors(model, grads)).items()}

    serving = params_from_jax(cfg, tree, device="cpu")
    shard_model(serving, mesh, fsdp=False)
    prompts = batch["tokens"]
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    max_seq = prompts.shape[1] + extra["new_tokens"]
    with torch.no_grad(), activation_sharding(mesh, rules):
        logits, caches = prefill(cfg, serving, inputs, max_seq=max_seq)
        facts["cache_shapes"] = [{k: (list(v.shape) if isinstance(v, torch.Tensor) else v)
                                  for k, v in _flat(c).items()} for c in caches]
        steps = [logits]
        for _ in range(extra["new_tokens"] - 1):
            logits, caches = decode_step(cfg, serving, torch.argmax(logits, -1)[:, None], caches)
            steps.append(logits)
        arrays["served_logits"] = torch.stack(steps, 1).numpy()
        ids = torch.argmax(torch.stack(steps, 1), -1).tolist()
        if extra["served"] == "requests":  # the serving entry point gives the same ids
            reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=extra["new_tokens"])
                    for i in range(b)]
            out = serve_requests(cfg, serving, reqs, max_seq, progress=lambda *_: None,
                                 device="cpu")
            facts["served_ids"] = [out[i] for i in range(b)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, ids)
    facts["ids"], facts["ids_every_rank"] = ids, every

    from repro_torch.launch.shardings import init_sharded
    from repro_torch.models import init_params

    drawn = init_sharded(cfg, torch.Generator().manual_seed(3), "cpu", mesh)
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    shard_model(whole, mesh)
    facts["sharded_init_equal"] = all(
        p.placements == q.placements and p.gather_to == q.gather_to
        and p.grad_to == q.grad_to and torch.equal(p.to_local(), q.to_local())
        for p, q in zip(drawn.parameters(), whole.parameters(), strict=True))
    facts["train_losses"], facts["params_unequal"] = [], []
    if extra["train"] and shape == (2, 2):  # an arch's own smoke config, both axes split
        trained, _, facts["train_losses"] = train(
            dataclasses.replace(tc, arch=extra["train"], steps=2, seq_len=prompts.shape[1]),
            progress=lambda *_: None, device="cpu",
            model=params_from_jax(cfg, tree, device="cpu"))
        facts["params_unequal"] = equal_over_model(list(trained.parameters()))
    return arrays, facts


def _tp(n: int, rank: int, data_dir: str, out_path: str, shape: str, *names: str) -> None:
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh

    dims = tuple(int(d) for d in shape.split("x"))
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    import time
    for name in names:
        t0 = time.perf_counter()
        arrays, facts = _tp_case(mesh, dims, name, data_dir)
        if os.environ.get("TP_TIMES"):
            print(name, time.perf_counter() - t0, facts.get("times"), flush=True)
        if rank == 0:
            np.savez(f"{out_path}.{name}.npz", **arrays)
            Path(f"{out_path}.{name}.json").write_text(json.dumps(facts))
    torch.distributed.barrier()


def _unequal_over_model(mesh, model, tensors) -> list:
    """The parameters replicated over 'model' whose `tensors` (one a
    parameter) differ between the 'model' peers."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    group, dim = mesh.get_group("model"), list(mesh.mesh_dim_names).index("model")
    unequal = []
    for (name, p), t in zip(model.named_parameters(), tensors, strict=True):
        if not isinstance(p.placements[dim], Replicate):
            continue
        t = (t.to_local() if hasattr(t, "to_local") else t).contiguous()
        peers = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(peers, t, group=group)
        if not all(torch.equal(peers[0], x) for x in peers):
            unequal.append(name)
    return unequal


def _sp_case(mesh, dims, name: str, data_dir: str):
    """One "sp" case: (arrays, facts) for rank 0."""
    import torch

    from repro_torch.interop import params_from_jax, tree_from_tensors
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.shardings import activation_rules, shard_model
    from repro_torch.models import forward
    from repro_torch.models.model import vocab_split
    from repro_torch.models.sharding import activation_sharding

    cfg, _, tree, batch = _tp_inputs(data_dir, name)
    arrays, facts = {}, {}
    model = params_from_jax(cfg, tree, device="cpu")
    shard_model(model, mesh)
    with torch.no_grad(), activation_sharding(mesh, activation_rules(mesh, True)):
        arrays["logits"] = forward(cfg, model, batch, mode="train").logits.numpy()
        facts["vocab_split"] = vocab_split(cfg, model)
    tc = _tp_config(dims, batch)
    odd = {k: v[:, :-1] if k in ("tokens", "labels") else v for k, v in batch.items()}
    for tag, rows in (("", batch), ("odd_", odd)):
        for p in model.parameters():
            p.grad = None
        counter = CollectiveCounter()
        with counter:
            got, grads, _ = _tp_grads(mesh, tc, cfg, model, rows, seq_parallel=True)
        facts[tag + "collectives"] = counter.result()
        facts |= {tag + k: v for k, v in got.items()}
        arrays |= {f"{tag}grad/{k}": v.numpy() for k, v in
                   _flat(tree_from_tensors(model, grads)).items()}
        facts[tag + "grads_unequal"] = _unequal_over_model(
            mesh, model, [p.grad for p in model.parameters()])
    return arrays, facts


def _combine_case(mesh, name: str, data_dir: str):
    """One "combine" case: (arrays, facts), the same on every rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.interop import params_from_jax
    from repro_torch.launch import dryrun
    from repro_torch.launch.shardings import activation_rules, shard_model
    from repro_torch.models import ShapeConfig, forward, init_caches
    from repro_torch.models.model import SEQ_DIMS, last_logits
    from repro_torch.models.sharding import activation_sharding

    cfg, extra, tree, batch = _tp_inputs(data_dir, name)
    prompts = batch["tokens"]
    b, new = prompts.shape[0], extra["new_tokens"]
    max_seq = prompts.shape[1] + new
    model = params_from_jax(cfg, tree, device="cpu")
    shard_model(model, mesh, fsdp=False)
    shape = ShapeConfig("combine", max_seq, b, "decode")
    tweaks = {extra["variant"]}
    _, split = dryrun._split(shape, mesh, tweaks)
    caches = dryrun._shard_caches(init_caches(cfg, split.rows, max_seq, "cpu"), cfg, mesh, b,
                                  "kv-seq-sharded" in tweaks)
    names = list(mesh.mesh_dim_names)
    local = sorted({k for c in caches for k, v in _flat(c).items()
                    if isinstance(v, DTensor) and k.replace("/", ".") in SEQ_DIMS
                    and v.placements[names.index("model")].is_shard(
                        SEQ_DIMS[k.replace("/", ".")])})
    group = split.group
    me = dist.get_rank(group) if split.rows < b else 0
    tokens = prompts[me * split.rows:(me + 1) * split.rows]
    steps = []
    with torch.no_grad(), activation_sharding(mesh, activation_rules(mesh), split,
                                              sharded_caches=True):
        mode = "prefill"
        for _ in range(new):
            out = forward(cfg, model, {"tokens": tokens}, caches=caches, mode=mode,
                          logits_whole=False)
            logits = last_logits(cfg, model, out.logits)
            steps.append(logits)
            tokens, mode = torch.argmax(logits, -1)[:, None], "decode"
    logits = torch.stack(steps, 1)
    if split.rows < b:  # every row's, in rank order
        parts = [torch.empty_like(logits) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, logits.contiguous(), group=group)
        logits = torch.cat(parts)
    return {"served_logits": logits.numpy()}, {"seq_sharded_leaves": local}


def _ep_case(mesh, dims, name: str, data_dir: str):
    """One "ep" case: (arrays, facts) for rank 0."""
    from repro_torch.interop import params_from_jax, tree_from_tensors
    from repro_torch.launch.shardings import shard_model

    cfg, _, tree, batch = _tp_inputs(data_dir, name)
    model = params_from_jax(cfg, tree, device="cpu")
    shard_model(model, mesh, moe_expert_axis="data")
    facts, grads, _ = _tp_grads(mesh, _tp_config(dims, batch), cfg, model, batch,
                                experts="data")
    facts["experts_split"] = sorted(n for n, p in model.named_parameters()
                                    if n.split(".")[-1] in ("w_gate", "w_up", "w_down")
                                    and ".ffn." in n and "dense" not in n and p.tp_split)
    return ({f"grad/{k}": v.numpy() for k, v in
             _flat(tree_from_tensors(model, grads)).items()}, facts)


def _vocab_checks(mesh) -> dict:
    """`vocab_parallel_nll` and `vocab_parallel_argmax` on each 'model'
    rank's slice of seeded logits against the whole-vocab versions:
    labels with -1 and on every slice's first and last id; ties planted
    across the slices."""
    import numpy as np
    import torch

    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.sharding import activation_sharding

    rng = np.random.default_rng(5)
    out = {}
    with activation_sharding(mesh, activation_rules(mesh)):
        t, r = tp.size(), tp.rank()
        v = 12 * t
        n = v // t
        logits = torch.from_numpy(rng.standard_normal((3, 8, v)).astype(np.float32) * 3)
        labels = torch.from_numpy(rng.integers(0, v, (3, 8)))
        edges = [e for q in range(t) for e in (q * n, q * n + n - 1)]
        labels.view(-1)[:len(edges)] = torch.tensor(edges)
        labels[2, -3:] = -1
        mask = (labels >= 0).float()
        whole = logits.clone().requires_grad_()
        per = torch.logsumexp(whole, -1) - torch.gather(whole, -1, labels.clamp_min(0)[..., None])[..., 0]
        want = (per * mask).sum() / mask.sum()
        want.backward()
        local = logits[..., r * n:(r + 1) * n].clone().requires_grad_()
        got = (tp.vocab_parallel_nll(local, labels) * mask).sum() / mask.sum()
        got.backward()
        out["nll"] = [got.item(), want.item()]
        out["grad_err"] = (local.grad - whole.grad[..., r * n:(r + 1) * n]).abs().max().item()
        ties = torch.from_numpy(rng.integers(0, 3, (6, 5, v)).astype(np.float32))
        ties[0, 0, :] = 0
        ties[0, 0, [n + 1, v - 1]] = 7          # equal maxima on two slices
        ties[1, 1, :] = 2                       # every logit equal
        got_ids = tp.vocab_parallel_argmax(ties[..., r * n:(r + 1) * n].contiguous())
        out["argmax_equal"] = torch.equal(got_ids, torch.argmax(ties, -1))
        out["argmax_tied_rows"] = int(((ties == ties.amax(-1, keepdim=True)).sum(-1) > 1)
                                      .sum())
    return out


def _sp(n: int, rank: int, data_dir: str, out_path: str, shape: str) -> None:
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh

    dims = tuple(int(d) for d in shape.split("x"))
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    plan = json.loads(Path(data_dir, "plan.json").read_text())
    results = {}
    for kind, fn in (("sp", lambda name: _sp_case(mesh, dims, name, data_dir)),
                     ("combine", lambda name: _combine_case(mesh, name, data_dir)),
                     ("ep", lambda name: _ep_case(mesh, dims, name, data_dir))):
        for name in plan[kind]:
            results[f"ep-{name}" if kind == "ep" else name] = fn(name)
    vocab = _vocab_checks(mesh)
    if rank == 0:
        for name, (arrays, facts) in results.items():
            np.savez(f"{out_path}.{name}.npz", **arrays)
            Path(f"{out_path}.{name}.json").write_text(json.dumps(facts))
        Path(f"{out_path}.vocab.json").write_text(json.dumps(vocab))
    torch.distributed.barrier()


def _tp64(n: int, rank: int, data_dir: str, out_path: str, shape: str, name: str) -> None:
    import numpy as np
    import torch

    from repro_torch.interop import params_from_jax, tree_from_tensors
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_model
    from repro_torch.models import recurrent
    from repro_torch.models.model import loss_fn

    # this process evaluates in float64 only: the model's f32 accumulations
    # (`.float()`) become f64, and the WKV-6 op (whose backward is written
    # for f32) is autograd through its plain scan
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    recurrent.wkv6 = lambda r, k, v, lw, u, s0=None: wkv_ref.wkv6_scan(
        r, k, v, torch.exp(lw), u, s0)
    cfg, _, tree, batch = _tp_inputs(data_dir, name)
    cfg = dataclasses.replace(cfg, dtype="float64")
    dims = tuple(int(d) for d in shape.split("x"))
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    model = params_from_jax(cfg, tree, device="cpu").double()
    shard_model(model, mesh)
    facts, grads, _ = _tp_grads(mesh, _tp_config(dims, batch), cfg, model, batch)
    arrays = {f"tp/{k}": v.numpy() for k, v in _flat(tree_from_tensors(model, grads)).items()}
    if rank == 0:
        one = params_from_jax(cfg, tree, device="cpu").double()
        loss, _ = loss_fn(cfg, one, batch)
        assert loss.dtype == torch.float64
        loss.backward()
        facts["one_loss"] = loss.item()
        arrays |= {f"one/{k}": v.numpy() for k, v in _flat(
            tree_from_tensors(one, [p.grad for p in one.parameters()])).items()}
        assert all(v.dtype == np.float64 for v in arrays.values())
        np.savez(f"{out_path}.{name}.npz", **arrays)
        Path(f"{out_path}.{name}.json").write_text(json.dumps(facts))
    torch.distributed.barrier()


def _tp_restart(n: int, rank: int, ckpt_dir: str, out_path: str) -> None:
    import torch

    from repro_torch.launch.train import TrainConfig, train

    kw = {"arch": "stablelm-3b", "batch_size": 8, "seq_len": 32, "mesh_axes": ("data", "model")}
    runs = {}
    for name, tc in (("first", TrainConfig(steps=2, checkpoint_dir=ckpt_dir, checkpoint_every=2,
                                           mesh_shape=(1, 2), **kw)),
                     ("resumed", TrainConfig(steps=4, checkpoint_dir=ckpt_dir,
                                             checkpoint_every=100, mesh_shape=(2, 1), **kw)),
                     ("straight", TrainConfig(steps=4, mesh_shape=(1, 2), **kw))):
        _, _, runs[name] = train(tc, progress=lambda *_: None, device="cpu")
    if rank == 0:
        Path(out_path).write_text(json.dumps(runs))
    torch.distributed.barrier()


def _spans(n: int, rank: int, out_path: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.collectives import bruck_all_reduce, ring_all_reduce, shift
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import (TrainConfig, current_world, layout, make_train_step,
                                          model_config)
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    gen = torch.Generator().manual_seed(rank)
    leaves = [torch.randn((7, 11), generator=gen),
              torch.randn((5,), generator=gen).to(torch.bfloat16)]
    counts = {}
    for name, reduce in (("ring", ring_all_reduce), ("bruck", bruck_all_reduce)):
        calls, sent = shift.calls, shift.bytes
        for x in leaves:
            reduce(x)
        counts[name] = [shift.calls - calls, shift.bytes - sent]

    tc = TrainConfig(arch="stablelm-3b", batch_size=2 * n, seq_len=16, grad_sync="bridge")
    cfg = model_config(tc)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = list(model.parameters())
    step = make_train_step(tc, layout(tc, current_world(), None))
    rows = slice(2 * rank, 2 * rank + 2)
    batch = {k: torch.from_numpy(v[rows])
             for k, v in SyntheticLM(cfg.vocab_size, 16).global_batch(0, 2 * n, 1).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            _, metrics, _ = step(model, adamw_init(params), batch)
            float(metrics["loss"])
    spans = [[e.name, e.time_range.start, e.time_range.end, e.is_user_annotation]
             for e in prof.events() if e.name.startswith("train.") or e.name == "outer"]
    if rank == 0:
        Path(out_path).write_text(json.dumps({
            "leaves": counts, "spans": spans, "shifts": list(step.shifts),
            "phases": step.phase_seconds(),
            "params": [[p.numel(), p.element_size()] for p in params]}))
    torch.distributed.barrier()


def _a2a_grad(n: int, rank: int, out_path: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.collectives import bruck_all_to_all

    rng = np.random.default_rng(7)  # every rank draws the same global arrays
    xs = rng.standard_normal((n, n, 3, 5)).astype(np.float32)
    ws = rng.standard_normal((n, n, 3, 5)).astype(np.float32)
    x = torch.from_numpy(xs[rank]).requires_grad_()
    out = bruck_all_to_all(x)
    want = torch.empty_like(x)
    dist.all_to_all_single(want, x.detach())
    (out * torch.from_numpy(ws[rank])).sum().backward()
    got = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(got, out.detach())
    lib = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(lib, want)
    grads = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(grads, x.grad)
    if rank == 0:
        np.savez(out_path, x=xs, w=ws, out=torch.stack(got).numpy(),
                 library=torch.stack(lib).numpy(), grad=torch.stack(grads).numpy())
    dist.barrier()


def _adamw(n: int, rank: int, out_path: str) -> None:
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import distribute
    from repro_torch.optim import adamw_init, adamw_update

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    layout = [((4, 6), (Shard(0), Shard(1))), ((6,), (Replicate(), Replicate())),
              ((8, 4), (Replicate(), Shard(0))), ((3, 8, 2), (Shard(1), Replicate()))]
    rng = np.random.default_rng(3)  # every rank draws the same global arrays
    whole = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for shape, _ in layout]
    grads = [[torch.from_numpy(10 * rng.standard_normal(shape).astype(np.float32))
              for shape, _ in layout] for _ in range(2)]
    params = [distribute(w, mesh, pl) for w, (_, pl) in zip(whole, layout, strict=True)]
    state, want_state = adamw_init(params), adamw_init(whole)
    gnorm, want_gnorm = [], []
    for step_grads in grads:
        shards = [distribute(g, mesh, pl) for g, (_, pl) in zip(step_grads, layout, strict=True)]
        _, state, om = adamw_update(shards, state, params, 1e-2)
        _, want_state, want_om = adamw_update(step_grads, want_state, whole, 1e-2)
        gnorm.append(om["grad_norm"].item())
        want_gnorm.append(want_om["grad_norm"].item())
    got = [p.full_tensor().numpy() for p in params]
    if rank == 0:
        np.savez(out_path, gnorm=gnorm, want_gnorm=want_gnorm, leaves=len(layout),
                 **{f"p{i}": g for i, g in enumerate(got)},
                 **{f"want_p{i}": w.numpy() for i, w in enumerate(whole)})
    torch.distributed.barrier()


def _pipeline(n: int, rank: int, in_path: str, out_path: str, n_micro: str) -> None:
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import run_pipeline

    data = np.load(in_path)
    stage_w, x = torch.from_numpy(data["stage_w"]), torch.from_numpy(data["x"])
    calls = [0]

    def stage_fn(w, h):  # a stage of one (D, D) layer or of several
        calls[0] += 1
        for layer in (w if w.dim() == 3 else [w]):
            h = torch.tanh(h @ layer)
        return h

    mesh = make_mesh((n,), ("pod",), "cpu")
    out = run_pipeline(mesh, "pod", stage_fn, stage_w, x, int(n_micro))
    counts = [None] * n
    torch.distributed.all_gather_object(counts, calls[0])
    if rank == 0:
        seq = []
        for xm in x.reshape(int(n_micro), -1, x.shape[-1]):  # the same microbatches
            for w in stage_w:
                xm = stage_fn(w, xm)
            seq.append(xm)
        np.savez(out_path, pipeline=out.numpy(), sequential=torch.cat(seq).numpy(),
                 calls=counts)
    torch.distributed.barrier()


def main() -> None:
    mode, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if mode == "collectives":
            _collectives(world, rank)
        elif mode == "a2a":
            _a2a(world, rank, *sys.argv[5:7])
        elif mode == "compressed":
            _compressed(world, rank, sys.argv[5])
        elif mode == "train":
            _train(world, rank, *sys.argv[5:])
        elif mode == "restart":
            _restart(world, rank, *sys.argv[5:7])
        elif mode == "mesh":
            _mesh(world, rank, *sys.argv[5:])
        elif mode == "elastic":
            _elastic(world, rank, *sys.argv[5:])
        elif mode == "spans":
            _spans(world, rank, sys.argv[5])
        elif mode == "a2a_grad":
            _a2a_grad(world, rank, sys.argv[5])
        elif mode == "adamw":
            _adamw(world, rank, sys.argv[5])
        elif mode == "tp":
            _tp(world, rank, *sys.argv[5:])
        elif mode == "sp":
            _sp(world, rank, *sys.argv[5:8])
        elif mode == "tp64":
            _tp64(world, rank, *sys.argv[5:9])
        elif mode == "tp_restart":
            _tp_restart(world, rank, *sys.argv[5:7])
        elif mode == "pipeline":
            _pipeline(world, rank, *sys.argv[5:8])
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

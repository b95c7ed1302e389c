"""Port parity: meshes, the sharding rules and 2-D (data x model) training
(`repro_torch/launch/{mesh,shardings,train}.py`, `models/sharding.py`,
`models/moe.py`'s groups across ranks and expert parallelism) vs the
reference.  The differentiable all-to-all and the sharded AdamW are held in
tests/test_torch_collectives.py and test_torch_optim.py, elastic restart in
test_torch_elastic.py.

The rule table is compared leaf by leaf with `repro.launch.shardings` on
stand-in meshes (`jax.sharding.AbstractMesh`: axis names and sizes, no
devices), for every architecture at its scaled-down and full shapes
(`jax.eval_shape`).  Training runs in gloo ranks spawned by
`tests/_torch_dist_worker.py` and is held to the reference's own bounds:
  - check 3 of tests/_distributed_worker.py (qwen3-moe smoke, batch 4 x 16,
    3 steps, gspmd) on (2, 2), (1, 4) and (4, 1) against the JAX package's
    single-device `train()` at rtol 2e-4 (its GSPMD computes the global
    batch's math whatever the mesh), and the MoE's groups across ranks on
    2 ranks without a mesh and on (2,);
  - stablelm-3b smoke on (2, 2), gspmd and bridge, against the port's
    unsharded run at rtol 2e-4.
"""
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402
from _torch_parity import both_params, flatten  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import shardings as ref_shardings  # noqa: E402
from repro.launch.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch.train import model_config as jax_model_config  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

LOSS_RTOL = 2e-4      # tests/_distributed_worker.py check 1; port vs JAX
CHECK3 = {"arch": "qwen3-moe-235b-a22b", "steps": 3, "batch_size": 4, "seq_len": 16}
# final parameters of two layouts: AdamW moves an element by about lr (up to
# 1.2e-4 in these warm-up steps) whatever its gradient's size, so a gradient
# near zero, summed in another order, can move it differently; a tenth of a
# step bounds that
PARAM_ATOL = 1e-5
STAND_INS = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
             ((1, 8), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _stand_ins():
    return [AbstractMesh(shape, axes) for shape, axes in STAND_INS]


def _keys(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path]


# --- the rule table -----------------------------------------------------------------


@pytest.mark.parametrize("scale", ["smoke", "full"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_leaf_spec_equals_the_reference(arch, scale):
    """Every leaf of the reference's parameter tree, stacked as the reference
    stacks it, on four stand-in meshes and both expert axes."""
    cfg = jax_configs.get(arch)
    if scale == "smoke":
        cfg = cfg.scaled_down()
    shapes = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert leaves
    for mesh in _stand_ins():
        for axis in ("model", "data"):
            for path, leaf in leaves:
                keys = _keys(path)
                want = ref_shardings._leaf_spec(mesh, keys, leaf.shape, axis)
                got = shardings._leaf_spec(mesh, keys, leaf.shape, axis)
                assert got == tuple(want), (keys, leaf.shape, mesh, axis)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_shardings_of_a_model_are_the_reference_leaves(arch, fsdp):
    """`param_shardings` of the port's `Model` (one module per layer): each
    parameter takes the spec of the reference's leaf it is a slice of, the
    stacked reps dim dropped."""
    cfg = configs.get(arch).scaled_down()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jax_configs.get(arch).scaled_down()
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.PRNGKey(0)))
    names = {id(p): n for n, p in model.named_parameters()}
    owners = interop._layout(model, lambda _, p: names[id(p)], list)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    specs = shardings.param_shardings(mesh, model, fsdp=fsdp)
    assert list(specs) == list(names.values())
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want = tuple(ref_shardings._leaf_spec(mesh, _keys(path), leaf.shape))
        if not fsdp:
            want = tuple(None if ax == "data" else ax for ax in want)
        owner = owners
        for k in _keys(path):
            owner = owner[int(k) if isinstance(owner, list) else k]
        stacked = isinstance(owner, list)
        for name in owner if stacked else [owner]:
            assert specs[name] == (want[1:] if stacked else want), (name, want)


def test_placements_invert_per_mesh_dimension():
    """A spec names a mesh axis per tensor dim; placements name a tensor dim
    per mesh axis.  The embedding's ("model", "data") on (V, d) over a
    ("data", "model") mesh is Shard(1) on 'data', Shard(0) on 'model'."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert shardings.placements(mesh, ("model", "data")) == (Shard(1), Shard(0))
    assert shardings.placements(mesh, ("data", "model")) == (Shard(0), Shard(1))
    assert shardings.placements(mesh, (None, "model", "data", None)) == (Shard(2), Shard(1))
    assert shardings.placements(mesh, (None, None)) == (Replicate(), Replicate())
    pod = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shardings.placements(pod, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="twice"):
        shardings.placements(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="not axes"):
        shardings.placements(mesh, ("pod", None))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "stablelm-3b", "recurrentgemma-9b"])
def test_spec_placement_round_trip(arch):
    """spec -> placements -> spec is the identity on every leaf's spec."""
    cfg = jax_configs.get(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    seen = 0
    for mesh in _stand_ins():
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            spec = shardings._leaf_spec(mesh, _keys(path), leaf.shape)
            back = shardings.spec_of(mesh, shardings.placements(mesh, spec), len(spec))
            assert back == spec, (_keys(path), spec, back)
            seen += any(ax is not None for ax in spec)
    assert seen
    pod = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = (("pod", "data"), None, "model")
    assert shardings.spec_of(pod, shardings.placements(pod, spec), 3) == spec


@pytest.mark.parametrize("shape,axes", STAND_INS + [((4,), ("data",)), ((2,), ("model",))])
def test_batch_cache_and_activation_rules_equal_the_reference(shape, axes):
    mesh = AbstractMesh(shape, axes)
    batch = {"tokens": (64, 16), "labels": (64, 16), "odd": (3, 5), "scalar": ()}
    want = ref_shardings.batch_shardings(
        mesh, {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in batch.items()})
    got = shardings.batch_shardings(mesh, batch)
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    caches = {"k": (2, 64, 16, 128, 8), "v": (2, 64, 3, 128, 8), "state": (3, 64, 32),
              "conv": (1, 4, 7, 32), "lat": (2, 64, 128, 48)}
    for kv_seq_shard in (False, True):
        want = ref_shardings.cache_shardings(
            mesh, {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in caches.items()},
            kv_seq_shard=kv_seq_shard)
        got = shardings.cache_shardings(mesh, caches, kv_seq_shard=kv_seq_shard)
        assert got == {k: tuple(v.spec) for k, v in want.items()}
    for seq_parallel in (False, True):
        want = ref_shardings.activation_rules(mesh, seq_parallel=seq_parallel)
        got = shardings.activation_rules(mesh, seq_parallel=seq_parallel)
        assert got == {k: tuple(v) for k, v in want.items()}


# --- training on gloo ranks ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    """jax_losses(batch, seq) -> (the JAX package's single-device losses at
    check 3's arch and steps with this global batch and sequence (check 3's
    by default), the .npz of its weights), each computed once."""
    runs = {}

    def get(batch, seq=CHECK3["seq_len"]):
        if (batch, seq) not in runs:
            jtc = JaxTrainConfig(grad_sync="gspmd",
                                 **{**CHECK3, "batch_size": batch, "seq_len": seq})
            _, _, want = jax_train(jtc, lambda *_: None)
            jp, _ = both_params(jax_model_config(jtc), seed=jtc.seed)
            path = tmp_path_factory.mktemp("check3") / "params.npz"
            np.savez(path, **flatten(jax.tree.map(np.asarray, jp)))
            runs[batch, seq] = want, path
        return runs[batch, seq]

    return get


def _mesh_runs(tmp_path, world, params, arch, steps, batch, seq, *runs, timeout=180):
    out = tmp_path / "losses.json"
    spawn("mesh", world, str(params), str(out), arch, str(steps), str(batch), str(seq), *runs,
          timeout=timeout)
    losses = json.loads(out.read_text())
    return losses, {run: dict(np.load(f"{out}.{run}.npz")) for run in runs}


@pytest.mark.parametrize("run,batch", [("gspmd@-", 4), ("gspmd@2", 4), ("gspmd@-", 6)])
def test_moe_groups_span_ranks_as_the_reference_forms_them(tmp_path, jax_losses, run, batch):
    """Check 3's shape on 2 ranks: its one group of 64 tokens spans both
    (32 each).  The reference forms its groups from the global token order,
    so the capacity (20, not 10) and the aux loss are the whole group's; the
    port's losses equal the JAX package's single-device ones.  With 6 rows
    (48 tokens a rank) the first group crosses the ranks' boundary and the
    second holds 32 tokens of rank 1 and 32 of padding."""
    want, params = jax_losses(batch)
    kw = {**CHECK3, "batch_size": batch}
    losses, _ = _mesh_runs(tmp_path, 2, params, *kw.values(), run)
    np.testing.assert_allclose(losses[run], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", ["2x2", "1x4", "4x1"])
def test_2d_moe_training_equals_jax(tmp_path, jax_losses, shape):
    """Check 3 on a (data, model) mesh of 4 gloo ranks: parameters and moments
    live as the rule table's shards (checked by the worker), the experts run
    in parallel over 'model' through the Bruck all-to-all, and the losses
    equal the JAX package's; on (2, 2) the final parameters also equal the
    unsharded run's on the same ranks."""
    want, params = jax_losses(CHECK3["batch_size"])
    runs = ["gspmd@-"] * (shape == "2x2") + [f"gspmd@{shape}"]
    losses, finals = _mesh_runs(tmp_path, 4, params, *CHECK3.values(), *runs)
    for run in runs:
        np.testing.assert_allclose(losses[run], want, rtol=LOSS_RTOL, err_msg=run)
    if shape == "2x2":
        whole, sharded = finals["gspmd@-"], finals[f"gspmd@{shape}"]
        assert sorted(whole) == sorted(sharded)
        for key, w in whole.items():
            np.testing.assert_allclose(sharded[key], w, atol=PARAM_ATOL, rtol=1e-5,
                                       err_msg=key)


def test_fewer_rows_than_ranks_split_over_the_batch_axes(tmp_path, jax_losses):
    """Check 3 with 2 rows on (2, 2): the rows split over 'data' only (as the
    reference's batch sharding), the two ranks of each 'model' group compute
    the same row, their one group of 32 tokens spans the 'data' ranks, and
    the experts still run in parallel over 'model'; the losses equal the JAX
    package's (the dry run's multipod training layout, 256 rows on 512
    ranks)."""
    want, params = jax_losses(2)
    losses, _ = _mesh_runs(tmp_path, 4, params, *{**CHECK3, "batch_size": 2}.values(),
                           "gspmd@2x2")
    np.testing.assert_allclose(losses["gspmd@2x2"], want, rtol=LOSS_RTOL)


def test_expert_parallel_peers_run_the_same_groups(tmp_path, jax_losses):
    """Batch 4 x 24 on (2, 2): 24 tokens a rank, global groups of 64 and 32.
    Ranks 0 and 1 (one 'model' group) hold rows of the first group only, but
    rank 2 holds rows of both and its peer rank 3 rows of the second alone.
    The peers of an expert exchange run the same groups, so their all-to-alls
    pair up (else the run hangs), and the losses equal the JAX package's."""
    kw = {**CHECK3, "seq_len": 24}
    want, params = jax_losses(kw["batch_size"], kw["seq_len"])
    losses, _ = _mesh_runs(tmp_path, 4, params, *kw.values(), "gspmd@2x2")
    np.testing.assert_allclose(losses["gspmd@2x2"], want, rtol=LOSS_RTOL)


def test_dots_remat_on_a_2d_moe_mesh_gives_the_bits_of_full(tmp_path, jax_losses):
    """Check 3 on (2, 2) under remat "dots": what a block gathers on use, the
    MoE's global groups and its Bruck exchange run again in the recompute as
    under "full" (the peers' all-to-alls pair up), so the losses and final
    parameters equal the "full" run's bit for bit, and the losses JAX's."""
    want, params = jax_losses(CHECK3["batch_size"])
    runs = ("gspmd@2x2", "gspmd@2x2@dots")
    losses, finals = _mesh_runs(tmp_path, 4, params, *CHECK3.values(), *runs)
    assert losses[runs[1]] == losses[runs[0]]
    for key, w in finals[runs[0]].items():
        np.testing.assert_array_equal(finals[runs[1]][key], w, err_msg=key)
    np.testing.assert_allclose(losses[runs[1]], want, rtol=LOSS_RTOL)


def test_dense_training_on_a_2d_mesh_equals_the_unsharded_run(tmp_path):
    """stablelm-3b smoke on (2, 2): gspmd (sharded, gathered on use) and
    bridge (replicated, gradients summed over 'data' by the Bruck
    all-reduce) against the port's unsharded run, 4 steps."""
    losses, finals = _mesh_runs(tmp_path, 4, "-", "stablelm-3b", 4, 8, 32,
                                "gspmd@-", "gspmd@2x2", "bridge@2x2")
    for run in ("gspmd@2x2", "bridge@2x2"):
        np.testing.assert_allclose(losses[run], losses["gspmd@-"], rtol=LOSS_RTOL)
        for key, w in finals["gspmd@-"].items():
            np.testing.assert_allclose(finals[run][key], w, atol=PARAM_ATOL, rtol=1e-5,
                                       err_msg=f"{run} {key}")

"""Port parity: the training slice (`loss_fn` and its gradients, remat, the
training driver, the Bridge gradient sync over gloo) vs the JAX package.

Weights are JAX-initialised and converted (`params_from_jax`); gradients come
back in the JAX tree layout (`tree_from_model`) and are compared leaf by
leaf.  All at f32.  Bounds:
  - loss rtol 1e-5; every gradient leaf atol 1e-5 + rtol 1e-4 (f32 sums in
    another order through the same model);
  - training losses over 4 steps rtol 2e-4, the bound of the reference's own
    bridge-vs-gspmd check (tests/_distributed_worker.py).
"""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_worker import spawn  # noqa: E402
from _torch_parity import assert_trees_close, both_params, flatten  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch import train as jax_train_mod  # noqa: E402
from repro.launch.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch.train import model_config as jax_model_config  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.launch.train import TrainConfig, build_parser, train  # noqa: E402
from repro_torch.launch.train import model_config as port_model_config  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402

GRAD_TOL = {"atol": 1e-5, "rtol": 1e-4}
LOSS_RTOL = 2e-4
TRAIN_KW = {"arch": "stablelm-3b", "steps": 4, "batch_size": 8, "seq_len": 32}


def _cfg(arch, remat):
    cfg = jax_configs.get(arch).scaled_down()
    if arch == "gemma3-4b":  # a window shorter than the sequence: masked tiles
        cfg = dataclasses.replace(cfg, window=8)
    return dataclasses.replace(cfg, dtype="float32", remat=remat)


def test_synthetic_lm_batches_equal_jax():
    for step in (0, 3):
        want = JaxSyntheticLM(512, 32, seed=5).global_batch(step, 8, 1)
        got = SyntheticLM(512, 32, seed=5).global_batch(step, 8, 1)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-4b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(arch, remat):
    """The MoE arch's loss includes 0.01 x its auxiliary loss, whose gradient
    reaches the router through the mean router probabilities.  rwkv6-3b is
    held to JAX without remat only (test_recurrent_loss_and_grads_match_jax)."""
    cfg = _cfg(arch, remat)
    jp, model = both_params(cfg)
    batch = JaxSyntheticLM(cfg.vocab_size, 32, seed=1).global_batch(0, 4, 1)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_loss_fn(cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics = loss_fn(model.cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["nll"].item(), float(want_m["nll"]), rtol=1e-5)
    if cfg.ffn == "moe":
        assert float(want_m["aux"]) > 0
        np.testing.assert_allclose(metrics["aux"].item(), float(want_m["aux"]), rtol=1e-5)
    else:
        assert metrics["aux"].item() == float(want_m["aux"]) == 0.0
    assert_trees_close(tree_from_model(model, "grad"), want_g, **GRAD_TOL)


def _loss_and_grads(cfg, batch):
    _, model = both_params(cfg)
    loss, metrics = loss_fn(model.cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), metrics, flatten(tree_from_model(model, "grad"))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_recurrent_loss_and_grads_match_jax(arch):
    """The recurrent archs (recurrentgemma-9b scaled down has both of its
    segments: rglru, rglru, local, rglru): their gradients pass through the
    ops' backward (the plain reverse loops on the CPU).  The port with and
    without remat gives the same bits, and both equal JAX's loss and
    gradients leaf by leaf.  JAX's side is taken without remat: its
    `jax.checkpoint` moves rwkv6-3b's embedding gradient, and against an f64
    evaluation of the port's model JAX's remat gradient lies 1.32e-5 away,
    its gradient without remat 8.16e-6 and the port's 7.5e-6
    (`tests/recurrent_bwd_readings.py`), so JAX's remat path is not the
    nearer reference there.  recurrentgemma-9b is held to JAX's remat
    gradients too, in test_loss_and_grads_match_jax."""
    cfg = _cfg(arch, False)
    batch = JaxSyntheticLM(cfg.vocab_size, 32, seed=1).global_batch(0, 4, 1)
    jp, _ = both_params(cfg)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_loss_fn(cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    runs = [_loss_and_grads(_cfg(arch, remat), batch) for remat in (True, False)]
    for key in runs[0][2]:
        np.testing.assert_array_equal(runs[0][2][key], runs[1][2][key], err_msg=key)
    for loss, metrics, grads in runs:
        assert loss == runs[0][0]
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(metrics["nll"].item(), float(want_m["nll"]), rtol=1e-5)
        assert_trees_close(grads, flatten(jax.tree.map(np.asarray, want_g)), **GRAD_TOL)


def test_remat_gives_the_same_gradients():
    """Full remat (torch.utils.checkpoint per block) changes nothing but memory."""
    grads = []
    for remat in (True, False):
        _, model = both_params(_cfg("stablelm-3b", remat))
        batch = SyntheticLM(model.cfg.vocab_size, 16, seed=2).global_batch(0, 2, 1)
        loss, _ = loss_fn(model.cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        grads.append(flatten(tree_from_model(model, "grad")))
    for key in grads[0]:
        np.testing.assert_array_equal(grads[0][key], grads[1][key], err_msg=key)


def test_remat_policy_dots_is_refused():
    _, model = both_params(_cfg("stablelm-3b", True))
    cfg = dataclasses.replace(model.cfg, remat_policy="dots")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        forward(cfg, model, {"tokens": tok}, mode="train")
    with torch.no_grad():  # no backward, no remat: the policy is not read
        forward(cfg, model, {"tokens": tok}, mode="train")


def test_single_rank_train_losses_track_jax():
    """4 steps of stablelm-3b smoke, gspmd, from the same converted weights."""
    jtc = JaxTrainConfig(grad_sync="gspmd", **TRAIN_KW)
    _, _, want = jax_train(jtc, lambda *_: None)
    _, model = both_params(jax_model_config(jtc), seed=jtc.seed)
    lines = []
    out_model, _, got = train(TrainConfig(grad_sync="gspmd", **TRAIN_KW), lines.append,
                              device="cpu", model=model)
    assert out_model is model and len(lines) == TRAIN_KW["steps"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_single_rank_rwkv6_train_losses_track_jax():
    """4 steps of rwkv6-3b smoke (the reference's default training arch),
    gspmd, from the same converted weights: the WKV-6 backward in every step."""
    kw = {**TRAIN_KW, "arch": "rwkv6-3b"}
    jtc = JaxTrainConfig(grad_sync="gspmd", **kw)
    _, _, want = jax_train(jtc, lambda *_: None)
    _, model = both_params(jax_model_config(jtc), seed=jtc.seed)
    _, _, got = train(TrainConfig(grad_sync="gspmd", **kw), lambda *_: None, device="cpu",
                      model=model)
    assert len(got) == kw["steps"] and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_train_takes_a_model_cut_in_depth_only():
    """`train` takes a model of its config cut to fewer layers (the card's
    smoke run trains recurrentgemma-9b's first pattern period so) and keeps
    its depth; a model that differs in anything else is refused."""
    tc = TrainConfig(**{**TRAIN_KW, "arch": "recurrentgemma-9b", "steps": 2})
    cfg = dataclasses.replace(port_model_config(tc), num_layers=3)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out, _, losses = train(tc, lambda *_: None, device="cpu", model=model)
    assert out is model and out.cfg.layer_kinds == ("rglru", "rglru", "local")
    assert len(losses) == 2 and np.isfinite(losses).all()
    other = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="does not match"):
        train(tc, lambda *_: None, device="cpu", model=other)


def test_train_cli_default_arch_is_the_references():
    """`TrainConfig.arch` and the `--arch` default are the reference's, read
    from the source of `repro/launch/train.py`, so that the two cannot drift
    apart."""
    tree = ast.parse(Path(jax_train_mod.__file__).read_text())
    flag = [kw.value.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
            and node.args and getattr(node.args[0], "value", None) == "--arch"
            for kw in node.keywords if kw.arg == "default"]
    field = [node.value.value for cls in ast.walk(tree)
             if isinstance(cls, ast.ClassDef) and cls.name == "TrainConfig"
             for node in cls.body
             if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "arch"]
    assert len(flag) == len(field) == 1
    assert TrainConfig().arch == build_parser().parse_args([]).arch == field[0] == flag[0] \
        == "rwkv6-3b"


@pytest.mark.parametrize("option,match", [
    ({"mesh_shape": (2, 2), "mesh_axes": ("data", "model")}, "ROADMAP A9"),
])
def test_unported_train_options_are_refused(option, match):
    with pytest.raises(NotImplementedError, match=match):
        train(TrainConfig(**{**TRAIN_KW, **option}), device="cpu")


def test_bridge_and_gspmd_over_gloo_ranks_equal_jax(tmp_path):
    """4 gloo ranks: the port's bridge losses equal its gspmd losses (the
    reference's tests/_distributed_worker.py check 1), and both equal the
    single-device JAX losses, since the global batch does not depend on the
    world size."""
    jtc = JaxTrainConfig(grad_sync="gspmd", **TRAIN_KW)
    _, _, want = jax_train(jtc, lambda *_: None)
    jp, _ = both_params(jax_model_config(jtc), seed=jtc.seed)
    np.savez(tmp_path / "params.npz", **flatten(jax.tree.map(np.asarray, jp)))
    out = tmp_path / "losses.json"
    spawn("train", 4, str(tmp_path / "params.npz"), str(out), timeout=240)
    losses = json.loads(out.read_text())
    np.testing.assert_allclose(losses["bridge"], losses["gspmd"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses["gspmd"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses["bridge"], want, rtol=LOSS_RTOL)


def test_single_rank_compressed_train_losses_track_jax():
    """4 steps of stablelm-3b smoke with bridge-compressed on one rank: the
    int8 quantization with error feedback runs on one device too, in both
    packages, from the same converted weights."""
    jtc = JaxTrainConfig(grad_sync="bridge-compressed", **TRAIN_KW)
    _, _, want = jax_train(jtc, lambda *_: None)
    _, model = both_params(jax_model_config(jtc), seed=jtc.seed)
    _, _, got = train(TrainConfig(grad_sync="bridge-compressed", **TRAIN_KW),
                      lambda *_: None, device="cpu", model=model)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_bridge_compressed_trains_over_gloo_ranks(tmp_path):
    """4 gloo ranks train with bridge-compressed: the reference's
    tests/_distributed_worker.py check 2 (finite losses, the last below 1.5 x
    the first)."""
    jtc = JaxTrainConfig(grad_sync="gspmd", **TRAIN_KW)
    jp, _ = both_params(jax_model_config(jtc), seed=jtc.seed)
    np.savez(tmp_path / "params.npz", **flatten(jax.tree.map(np.asarray, jp)))
    out = tmp_path / "losses.json"
    spawn("train", 4, str(tmp_path / "params.npz"), str(out), "bridge-compressed",
          timeout=240)
    losses = json.loads(out.read_text())["bridge-compressed"]
    assert len(losses) == TRAIN_KW["steps"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 1.5

"""Port parity: the checkpoint store (`repro_torch/checkpoint/store.py`), the
checkpointed fabric playback, and training restart, vs the reference.

The store's own cases are the reference's (tests/test_fault_tolerance.py:
round trip, atomicity and garbage collection, shape mismatch) on torch
tensors.  Checkpoints cross between the packages both ways: the same tree
saved by each gives the same manifest (keys, shapes, dtypes) and the same
arrays, and each package restores the other's.  A bf16 leaf is written as
its 2-byte words by both (numpy has no bf16; JAX's arrays go through
`ml_dtypes`); the reference's own `restore_into` cannot cast those words to
bf16 ("No cast function available", for its own checkpoints too), so its side
of a bf16 leaf is read with `restore` and viewed as `ml_dtypes.bfloat16`.
Training restart: the reference's bound (rtol 1e-4) for a resumed run against
the straight one (one rank, and 2 gloo ranks of which rank 0 writes), and the
port-vs-JAX loss bound of tests/test_torch_train.py (rtol 2e-4) where a run
resumes from the other package's checkpoint.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_worker import spawn  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core import PAPER_DEFAULT as REF_CM  # noqa: E402
from repro.core import fabricsim as ref_fabricsim  # noqa: E402
from repro.core import schedules as ref_schedules  # noqa: E402
from repro.launch.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.checkpoint import (garbage_collect, latest_step, restore,  # noqa: E402
                                    restore_into, save)
from repro_torch.core import PAPER_DEFAULT, FabricSim, latest_snapshot, schedules  # noqa: E402
from repro_torch.launch.train import TrainConfig, build_parser, train  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402

MB = 1024.0 ** 2
RESTART_RTOL = 1e-4      # the reference's (tests/test_fault_tolerance.py:143-144)
LOSS_RTOL = 2e-4         # port vs JAX losses (tests/test_torch_train.py)
TRAIN_KW = {"arch": "stablelm-3b", "batch_size": 4, "seq_len": 32}


# --- the store (tests/test_fault_tolerance.py:25-55 on the port) ---------------


def _tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.ones((4,), dtype=torch.float32)},
        "nested": [torch.zeros((2, 2)), {"x": torch.full((5,), 7.0)}],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save(d, 10, tree)
    assert latest_step(d) == 10
    back = restore_into(d, _tree())
    for a, b in zip(_leaves(tree), _leaves(back), strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_atomicity_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        save(d, s, _tree())
    assert latest_step(d) == 4
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    removed = garbage_collect(d, keep=2)
    assert len(removed) == 2
    assert latest_step(d) == 4
    restore(d, 3)  # kept
    with pytest.raises(FileNotFoundError):
        restore(d, 1)  # collected
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"))


def test_checkpoint_shape_mismatch_and_missing_key_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 1, {"w": torch.zeros((3, 4))})
    with pytest.raises(ValueError):
        restore_into(d, {"w": torch.zeros((4, 4))})
    with pytest.raises(KeyError, match=r"\['v'\]"):
        restore_into(d, {"w": torch.zeros((3, 4)), "v": torch.zeros(2)})


def test_restore_into_casts_to_the_template_and_places_on_device(tmp_path):
    """Each leaf takes the template leaf's dtype; `device=` places every
    tensor leaf (a meta template costs no memory); bf16 round-trips bit for
    bit through its 2-byte words; a stale `.tmp` of a crashed save is
    replaced."""
    d = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    bits = torch.tensor([0x3F80, 0x7F7F, 0x0001, 0x8000, 0xFF80, 0x7FC1], dtype=torch.int32)
    bf16 = bits.to(torch.int16).view(torch.bfloat16)
    save(d, 2, {"h": bf16, "f": torch.linspace(-1, 1, 6), "i": torch.tensor(7, dtype=torch.int32)})
    back = restore_into(d, {"h": torch.empty(6, dtype=torch.bfloat16, device="meta"),
                            "f": torch.empty(6, dtype=torch.float64, device="meta"),
                            "i": torch.empty((), dtype=torch.int32, device="meta")},
                        device="cpu")
    assert back["h"].dtype == torch.bfloat16 and back["h"].device.type == "cpu"
    assert torch.equal(back["h"].view(torch.int16), bf16.view(torch.int16))
    assert back["f"].dtype == torch.float64 and back["i"].item() == 7
    as_f32 = restore_into(d, {"h": torch.zeros(6), "i": np.zeros((), np.int64)})
    assert torch.equal(as_f32["h"].view(torch.int32), bf16.float().view(torch.int32))
    assert as_f32["i"].dtype == np.int64 and as_f32["i"] == 7
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000002"]


# --- checkpoints across the packages -------------------------------------------


def _both_trees(seed=0):
    """The same tree in each package: bf16 and f32 leaves, nested dicts,
    lists and tuples, and each package's AdamW state (a dataclass)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    h = rng.standard_normal(7).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    jax_tree = {"params": {"w": jnp.asarray(w), "h": jnp.asarray(h, jnp.bfloat16),
                           "blocks": [jnp.asarray(w[0]), (jnp.asarray(ids),)]},
                "opt": jax_adamw_init({"w": jnp.asarray(w)})}
    port_tree = {"params": {"w": torch.from_numpy(w), "h": torch.from_numpy(h).bfloat16(),
                            "blocks": [torch.from_numpy(w[0].copy()),
                                       (torch.from_numpy(ids),)]},
                 "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                                   m={"w": torch.zeros(3, 5)}, v={"w": torch.zeros(3, 5)})}
    return jax_tree, port_tree


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_the_same_tree_gives_the_same_checkpoint_in_both_packages(tmp_path):
    jax_tree, port_tree = _both_trees()
    ref_store.save(str(tmp_path / "ref"), 5, jax_tree)
    save(str(tmp_path / "port"), 5, port_tree)
    want, got = _manifest(tmp_path / "ref", 5), _manifest(tmp_path / "port", 5)
    assert got == want
    assert "['opt'].step" in got["keys"] and "['params']['blocks'][1][0]" in got["keys"]
    assert got["dtypes"]["['params']['h']"] == "bfloat16"
    ref_raw, raw = ref_store.restore(str(tmp_path / "ref")), restore(str(tmp_path / "port"))
    assert sorted(raw) == sorted(ref_raw)
    for k, a in ref_raw.items():
        assert raw[k].dtype.itemsize == a.dtype.itemsize and raw[k].shape == a.shape, k
        assert raw[k].tobytes() == a.tobytes(), k


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    jax_tree, port_tree = _both_trees(seed=1)
    d = str(tmp_path / "ref")
    ref_store.save(d, 3, jax_tree)
    back = restore_into(d, port_tree)
    assert isinstance(back["opt"], AdamWState) and back["opt"].step.dtype == torch.int32
    assert back["params"]["h"].dtype == torch.bfloat16
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    from repro_torch.checkpoint.store import _flatten
    got = _flatten(back)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [k for k, _ in got]
    for (_, w), (k, g) in zip(want, got, strict=True):
        w = np.asarray(w)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    jax_tree, port_tree = _both_trees(seed=2)
    d = str(tmp_path / "port")
    save(d, 4, port_tree)
    assert ref_store.latest_step(d) == 4
    f32 = {"params": {k: v for k, v in jax_tree["params"].items() if k != "h"},
           "opt": jax_tree["opt"]}
    back = ref_store.restore_into(d, f32)
    for (p, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(f32)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0], strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(p))
    h = ref_store.restore(d)["['params']['h']"].view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(h, np.asarray(jax_tree["params"]["h"]))
    with pytest.raises(ValueError, match="cast"):  # the reference's own limit
        ref_store.restore_into(d, jax_tree)


# --- checkpointed fabric playback (tests/test_faults.py:355-395 on the port) -----


def _phases(sched_mod, n=12, k=4):
    return tuple((sched_mod.static_schedule("a2a", n, 2), MB) for _ in range(k))


def test_checkpointed_trace_equals_straight_run(tmp_path):
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    phases = _phases(schedules)
    straight = FabricSim(mode="sparse", chunks_per_msg=4).run_trace(
        phases, cm, capture_state=True)
    d = str(tmp_path / "ckpt")
    chk = FabricSim(mode="sparse", chunks_per_msg=4).run_trace(
        phases, cm, capture_state=True, checkpoint_dir=d, checkpoint_every=2)
    assert chk.completion == straight.completion
    assert chk.phase_done == straight.phase_done
    assert chk.chunks_moved == straight.chunks_moved
    assert chk.final_state == straight.final_state
    # every=2 over 4 phases -> checkpoints at boundaries 2 and 4
    assert latest_step(d) == 4
    assert latest_snapshot(d) == straight.final_state
    want = ref_fabricsim.FabricSim(mode="sparse", chunks_per_msg=4).run_trace(
        _phases(ref_schedules), REF_CM.replace(delta=1e-3), capture_state=True,
        checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=2)
    assert dataclasses.asdict(chk.final_state) == dataclasses.asdict(want.final_state)
    assert _manifest(d, 4) == _manifest(tmp_path / "ref", 4)


def test_checkpointed_playback_atomicity_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    FabricSim(mode="sparse", chunks_per_msg=4).run_trace(
        _phases(schedules), PAPER_DEFAULT.replace(delta=1e-3), checkpoint_dir=d,
        checkpoint_every=1)
    assert latest_step(d) == 4
    garbage_collect(d, keep=2)
    assert latest_step(d) == 4
    restore(d, 4)  # survivors restore fine
    with pytest.raises(FileNotFoundError):
        restore(d, 1)  # collected
    assert latest_snapshot(str(tmp_path / "empty")) is None


# --- training restart -----------------------------------------------------------


def _port_run(steps, ckdir=None, every=3, arch="stablelm-3b", progress=None):
    tc = TrainConfig(**{**TRAIN_KW, "arch": arch}, steps=steps, checkpoint_dir=ckdir,
                     checkpoint_every=every)
    return train(tc, progress or (lambda *_: None), device="cpu")


@pytest.mark.parametrize("arch", ["stablelm-3b", "rwkv6-3b"])
def test_train_restart_resumes(tmp_path, arch):
    """Train 6 steps; against train 3, 'crash', resume 3 in a fresh `train()`:
    the same losses at the reference's rtol, and here on the CPU the same
    bits, parameters and AdamW state included."""
    model, opt, full = _port_run(6, arch=arch)
    d = str(tmp_path / "ckpt")
    _, _, part1 = _port_run(3, d, arch=arch)
    lines = []
    model2, opt2, part2 = _port_run(6, d, arch=arch, progress=lines.append)
    assert lines[0].startswith("resumed from step 3 ")
    assert len(part2) == 3 and latest_step(d) == 6
    np.testing.assert_allclose(part2, full[3:], rtol=RESTART_RTOL)
    np.testing.assert_allclose(part1, full[:3], rtol=RESTART_RTOL)
    assert part1 + part2 == full
    for a, b in zip(model.parameters(), model2.parameters(), strict=True):
        assert torch.equal(a, b)
    assert opt2.step.dtype == torch.int32 and int(opt2.step) == int(opt.step) == 6
    for a, b in zip(opt.m + opt.v, opt2.m + opt2.v, strict=True):
        assert torch.equal(a, b)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The two packages' 3-step training checkpoints hold the same keys,
    shapes and dtypes (`['params'][...]`, `['opt'].step`, `.m`, `.v`); the
    reference's, resumed by the port's `train()`, gives the reference's
    straight losses of steps 4-6, and the port's, resumed by the reference's,
    the port's (each package draws its own weights from the seed)."""
    jtc = dict(TRAIN_KW, steps=6)
    _, _, want = jax_train(JaxTrainConfig(**jtc), lambda *_: None)
    jd, d = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train(JaxTrainConfig(**dict(jtc, steps=3), checkpoint_dir=jd, checkpoint_every=3),
              lambda *_: None)
    _port_run(3, d)
    got = _manifest(d, 3)
    assert got == _manifest(jd, 3)
    assert any(k.startswith("['opt'].m['decoder'][0][0]") for k in got["keys"])
    assert got["dtypes"]["['opt'].step"] == "int32"
    _, _, resumed = _port_run(6, jd, every=100)
    np.testing.assert_allclose(resumed, want[3:], rtol=LOSS_RTOL)
    _, _, port_full = _port_run(6)
    _, _, back = jax_train(JaxTrainConfig(**jtc, checkpoint_dir=d, checkpoint_every=100),
                           lambda *_: None)
    np.testing.assert_allclose(back, port_full[3:], rtol=LOSS_RTOL)


def test_train_restart_over_gloo_ranks(tmp_path):
    """2 gloo ranks, bridge sync: every rank resumes from the checkpoint rank
    0 wrote alone, and the resumed losses equal the straight run's."""
    out, d = tmp_path / "losses.json", tmp_path / "ckpt"
    spawn("restart", 2, str(d), str(out), timeout=240)
    got = json.loads(out.read_text())
    np.testing.assert_allclose(got["first"] + got["resumed"], got["straight"],
                               rtol=RESTART_RTOL)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000002"]
    for rank, lines in enumerate(got["lines"]):
        saved = [line for line in lines if line.startswith("saved step")]
        assert len(saved) == (1 if rank == 0 else 0), (rank, saved)
        assert sum(line.startswith("resumed from step 2 ") for line in lines) == 1


def test_train_cli_takes_a_checkpoint_dir():
    args = build_parser().parse_args(["--checkpoint-dir", "ckpt"])
    assert args.checkpoint_dir == "ckpt"
    assert TrainConfig().checkpoint_every == 10

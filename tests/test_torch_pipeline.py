"""Port parity: GPipe over a mesh axis (`repro_torch/launch/pipeline.py`),
check 4 of tests/_distributed_worker.py: the reference's tanh stages (S = 4
stages of a (16, 16) weight, batch 8) on a (4,) ("pod",) mesh of gloo ranks
spawned by `tests/_torch_dist_worker.py`, against the JAX package's
sequential `stage_fn` at the reference's atol 1e-5 and against the port's
sequential run of the same microbatches bit for bit (the last stage runs the
same ops on the same microbatch; the other stages add zeros).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402

S, D = 4, 16


def _stages():
    """The reference's check 4 inputs and its sequential output."""
    key = jax.random.PRNGKey(0)
    stage_w = jax.random.normal(key, (S, D, D)) / jnp.sqrt(D)
    x = jax.random.normal(key, (8, D))
    seq = x
    for s in range(S):
        seq = jnp.tanh(seq @ stage_w[s])
    return np.asarray(stage_w), np.asarray(x), np.asarray(seq)


@pytest.mark.parametrize("n_micro", [4, 1, 2, 8])
def test_gpipe_equals_sequential(tmp_path, n_micro):
    stage_w, x, want = _stages()
    np.savez(tmp_path / "in.npz", stage_w=stage_w, x=x)
    spawn("pipeline", S, str(tmp_path / "in.npz"), str(tmp_path / "out.npz"), str(n_micro),
          timeout=120)
    r = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(r["pipeline"], want, atol=1e-5)
    np.testing.assert_array_equal(r["pipeline"], r["sequential"])
    # each stage ran its stage_fn once a microbatch: no bubble tick computes
    np.testing.assert_array_equal(r["calls"], [n_micro] * S)


def test_gpipe_on_two_stages_of_two_layers(tmp_path):
    """A stage may hold several layers: 2 ranks, each stage two of the four
    tanh layers, 4 microbatches."""
    stage_w, x, want = _stages()
    np.savez(tmp_path / "in.npz", stage_w=stage_w.reshape(2, 2, D, D), x=x)
    spawn("pipeline", 2, str(tmp_path / "in.npz"), str(tmp_path / "out.npz"), "4",
          timeout=120)
    r = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(r["pipeline"], want, atol=1e-5)
    np.testing.assert_array_equal(r["pipeline"], r["sequential"])

"""Port parity: the Bruck / ring / Bridge collectives over `torch.distributed`.

Each case spawns one process per rank on gloo (CPU) and mirrors the JAX
package's tests/_multidevice_worker.py: reduce-scatter, all-gather (with and
without the planner's OCS schedules), ring, Bruck and Bridge all-reduce on a
(7, 11) tensor, against NumPy sums at atol 1e-5.  Non-power-of-two world
sizes (6) exercise the remainder rule; a world of one returns its input.
Every spawn has a time limit and fails at it rather than hanging.

The Bruck all-to-all is held bit for bit to the NumPy transpose (n = 2..5)
and to JAX's `bruck_all_to_all` on 4 host devices; the int8 compressed
all-reduce to the reference's two gates and to its arithmetic in NumPy.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("n", [1, 4, 6, 8])
def test_collectives_over_gloo_ranks_match_numpy_sums(n):
    outs = spawn("collectives", n, timeout=120)
    lines = outs[0].split()
    assert outs[0].strip().endswith("ALL-OK")
    assert lines.count("ok") == (7 if n == 1 else 9)


JAX_A2A = """
import os, sys
n = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.collectives import bruck_all_to_all
from repro.collectives._compat import shard_map
from repro.launch.mesh import make_mesh
assert jax.device_count() == n
x = np.load(sys.argv[2])
f = shard_map(lambda a: bruck_all_to_all(a, "ring"), mesh=make_mesh((n,), ("ring",)),
              in_specs=P("ring"), out_specs=P("ring"))
np.save(sys.argv[3], np.asarray(jax.jit(f)(x.reshape((n * n,) + x.shape[2:]))).reshape(x.shape))
"""


def _a2a_inputs(n, path):
    x = np.random.default_rng(n).standard_normal((n, n, 4, 3)).astype(np.float32)
    np.save(path, x)
    return x


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_bruck_all_to_all_over_gloo_ranks_is_exact(n, tmp_path):
    """Rank r sends row p of its (n, 4, 3) input to rank p: out[r][p] =
    x[p][r], bit for bit (pure data movement); n = 3, 5 take the remainder
    rule of the slot sets."""
    x = _a2a_inputs(n, tmp_path / "x.npy")
    spawn("a2a", n, str(tmp_path / "x.npy"), str(tmp_path / "out"), timeout=120)
    got = np.stack([np.load(tmp_path / f"out.{r}.npy") for r in range(n)])
    np.testing.assert_array_equal(got, x.transpose(1, 0, 2, 3))


def test_bruck_all_to_all_equals_jax_on_four_devices(tmp_path):
    """The same seeded inputs through JAX's bruck_all_to_all on 4 forced host
    devices (a subprocess, as tests/test_collectives_multidevice.py runs its
    worker) and through the port on 4 gloo ranks: the same bits."""
    n = 4
    _a2a_inputs(n, tmp_path / "x.npy")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", JAX_A2A, str(n), str(tmp_path / "x.npy"),
                           str(tmp_path / "jax.npy")], env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    spawn("a2a", n, str(tmp_path / "x.npy"), str(tmp_path / "out"), timeout=120)
    got = np.stack([np.load(tmp_path / f"out.{r}.npy") for r in range(n)])
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax.npy"))


def _numpy_compressed(glob, ef):
    """The reference's int8 arithmetic in NumPy, f32 throughout: per leaf, a
    shared scale max_r |g_r + e_r| / 127, round half to even, clip, an int32
    sum; returns (sum, new residuals)."""
    v = glob + ef
    scale = np.abs(v).max() / np.float32(127.0)
    q = np.clip(np.round(v / max(scale, np.float32(1e-30))), -127, 127).astype(np.int8)
    total = q.astype(np.int32).sum(axis=0).astype(np.float32) * scale
    return total, v - q.astype(np.float32) * scale


@pytest.mark.parametrize("n", [2, 3, 4])
def test_compressed_all_reduce_over_gloo_ranks(n, tmp_path):
    """The reference's gates (tests/_multidevice_worker.py: relative error of
    round 1 below 0.05; error feedback: round 1 + round 2 within 2 x round 1's
    error of twice the sum), and both rounds equal to the same int8
    arithmetic in NumPy."""
    spawn("compressed", n, str(tmp_path / "out.npz"), timeout=120)
    out = np.load(tmp_path / "out.npz")
    for i in range(2):
        glob = out[f"g{i}"]
        want_sum = glob.sum(axis=0)
        ef = np.zeros_like(glob)
        want1, ef = _numpy_compressed(glob, ef)
        want2, _ = _numpy_compressed(glob, ef)
        np.testing.assert_array_equal(out[f"round1_{i}"], want1)
        np.testing.assert_array_equal(out[f"round2_{i}"], want2)
        err1 = np.abs(out[f"round1_{i}"] - want_sum).max()
        rel = err1 / np.abs(want_sum).max()
        assert rel < 0.05, f"int8 quantization error too large: {rel}"
        err_fb = np.abs(out[f"round1_{i}"] + out[f"round2_{i}"] - 2 * want_sum).max()
        assert err_fb <= 2 * err1 + 1e-6, (err_fb, err1)


def test_bruck_all_to_all_is_differentiable(tmp_path):
    """4 gloo ranks: the exchange equals dist.all_to_all_single bit for bit,
    and the gradient of sum(out * w) is the plain transpose of w over the
    (rank, block) axes: d x_i[j] = w_j[i]."""
    out = tmp_path / "a2a.npz"
    spawn("a2a_grad", 4, str(out), timeout=120)
    r = np.load(out)
    np.testing.assert_array_equal(r["out"], r["library"])
    np.testing.assert_array_equal(r["out"], r["x"].transpose(1, 0, 2, 3))
    np.testing.assert_array_equal(r["grad"], r["w"].transpose(1, 0, 2, 3))

"""Port parity: the Bruck / ring / Bridge collectives over `torch.distributed`.

Each case spawns one process per rank on gloo (CPU) and mirrors the JAX
package's tests/_multidevice_worker.py: reduce-scatter, all-gather (with and
without the planner's OCS schedules), ring, Bruck and Bridge all-reduce on a
(7, 11) tensor, against NumPy sums at atol 1e-5.  Non-power-of-two world
sizes (6) exercise the remainder rule; a world of one returns its input.
Every spawn has a time limit and fails at it rather than hanging.
"""
import pytest

pytest.importorskip("torch")

from _torch_dist_worker import spawn  # noqa: E402


@pytest.mark.parametrize("n", [1, 4, 6, 8])
def test_collectives_over_gloo_ranks_match_numpy_sums(n):
    outs = spawn("collectives", n, timeout=120)
    lines = outs[0].split()
    assert outs[0].strip().endswith("ALL-OK")
    assert lines.count("ok") == (7 if n == 1 else 9)

"""Kernel B6 (the certified fabric playback) on the card against its plain
version, and the card's `batch_run` against the NumPy engine.

This file imports no JAX, so it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_playback.py``.
Its CPU parity with the reference is `tests/test_torch_fabric.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PAPER_DEFAULT, batchsim, schedules  # noqa: E402
from repro_torch.kernels.playback import kernel as playback_kernel  # noqa: E402
from repro_torch.kernels.playback import ref as playback_ref  # noqa: E402

MB = 1024.0 ** 2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _lanes(n: int, r: int, rng):
    seen, lanes = set(), []
    for kind in ("a2a", "rs", "ag"):
        for _, sched in schedules.candidate_schedules(kind, n, 4 * MB, PAPER_DEFAULT, r=r):
            if (sched.kind, sched.x) not in seen:
                seen.add((sched.kind, sched.x))
                lanes.append(batchsim.BatchLane(schedule=sched,
                                                m_bytes=float(rng.uniform(0.05, 8.0)) * MB))
    lanes.append(batchsim.BatchLane(schedule=lanes[0].schedule, m_bytes=0.0))
    return lanes


def _tapes(lanes, n, rng, device):
    tapes = [batchsim.compile_tape(lane.schedule) for lane in lanes]
    m = np.array([lane.m_bytes for lane in lanes])
    nb = (m[:, None] * np.stack([t.arrays["counts"] for t in tapes])) / n
    ch = np.stack([t.arrays["changed_pay"] for t in tapes]).copy()
    ch[:, 0] = False
    de = rng.uniform(0.0, 1e-3, len(lanes))
    arrays = (nb, np.stack([t.arrays["g_step"] for t in tapes]),
              np.stack([t.arrays["hops"] for t in tapes]), ch, de)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 12, 48, 96, 97])
@pytest.mark.parametrize("r", [2, 3])
def test_cuda_playback_equals_plain_bit_for_bit(n, r):
    """Every deduped candidate of (n, r) and a zero-payload lane, C in
    {1, 4, 8}: B6 gives the plain version's bits, twice."""
    _need_cuda()
    rng = np.random.default_rng(100 * n + r)
    t = _tapes(_lanes(n, r, rng), n, rng, "cuda")
    cm = PAPER_DEFAULT
    for C in (1, 4, 8):
        kw = {"n": n, "C": C, "alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h, "beta": cm.beta}
        before = playback_kernel.fabric_playback.launches
        got = playback_kernel.fabric_playback(*t, **kw)
        again = playback_kernel.fabric_playback(*t, **kw)
        assert playback_kernel.fabric_playback.launches == before + 2
        want = playback_ref.fabric_playback(*t, **kw)
        for a, b, w in zip(got, again, want, strict=True):
            assert a.dtype == torch.float64 and torch.equal(a, w) and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_batch_run_equals_numpy():
    """The card's backend equals the NumPy engine on every result field, a
    straggler lane keeping the guarded NumPy path."""
    _need_cuda()
    rng = np.random.default_rng(7)
    n = 48
    lanes = _lanes(n, 2, rng)
    lanes.append(batchsim.BatchLane(schedule=lanes[0].schedule, m_bytes=MB,
                                    link_speed=tuple([0.3] + [1.0] * (n - 1))))
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    want = batchsim.batch_run(lanes, cm, chunks_per_msg=4)
    got = batchsim.batch_run(lanes, cm, chunks_per_msg=4, backend="torch")
    assert got.backend == "torch" and not got.certified[-1]
    for field in ("completion", "node_done", "step_done", "chunks_moved", "reconfigs_paid",
                  "delta_stall", "certified", "fast_path"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field

"""Kernel B6 (the certified fabric playback) on the card against its plain
version, and the card's `batch_run` against the NumPy engine.

This file imports no JAX, so it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_playback.py``.
Its CPU parity with the reference is `tests/test_torch_fabric.py`; the
kernel's layout is pinned on the CPU by `tests/test_torch_playback_layout.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

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


def _same_as_plain_twice(t, kw, plan=None):
    """B6 on `plan` (None: its own) gives the plain version's bits, twice,
    and launches once a call."""
    before = playback_kernel.fabric_playback.launches
    got = playback_kernel.fabric_playback(*t, **kw, _plan=plan)
    again = playback_kernel.fabric_playback(*t, **kw, _plan=plan)
    assert playback_kernel.fabric_playback.launches == before + 2
    want = playback_ref.fabric_playback(*t, **kw)
    for a, b, w in zip(got, again, want, strict=True):
        assert a.dtype == torch.float64 and torch.equal(a, w) and torch.equal(a, b), plan


def _kw(n, C):
    cm = PAPER_DEFAULT
    return {"n": n, "C": C, "alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h, "beta": cm.beta}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8, 16])
def test_cuda_playback_on_every_cluster_size(cluster):
    """n = 1536 (the "jax" tier's n), its candidates of at most 300 hops, C =
    4, on 1 to 16 CTAs (pushes across every CTA boundary; 1536 is no
    multiple of 3 CTAs' threads), and n = 97 with its trains in registers,
    shared and device memory on the same CTAs (registers only at C = 8, a
    power of two)."""
    _need_cuda()
    rng = np.random.default_rng(1536 + cluster)
    lanes = [lane for lane in _lanes(1536, 2, rng)
             if sum(batchsim.compile_tape(lane.schedule).hops) <= 300]
    t = _tapes(lanes, 1536, rng, "cuda")
    _same_as_plain_twice(t, _kw(1536, 4), playback_kernel.launch_plan(1536, 4, cluster=cluster))
    t = _tapes(_lanes(97, 3, rng), 97, rng, "cuda")
    for comp in playback_kernel.PLACEMENTS:
        for C in (3, 8, 20):
            if comp == "registers" and C not in playback_kernel.REG_SLOTS:
                continue
            _same_as_plain_twice(t, _kw(97, C), playback_kernel.launch_plan(
                97, C, cluster=cluster, comp=comp))


@pytest.mark.cuda
@pytest.mark.parametrize("n,C,cluster", [(1024, 16, 1), (1025, 16, 2), (2048, 8, 1),
                                         (2049, 8, 2), (4096, 2, 1), (4097, 2, 2), (97, 20, 1),
                                         (1536, 3, 1)])
def test_cuda_playback_at_the_plans_thresholds(n, C, cluster):
    """Where the plan goes from one CTA to two (and the memory kernel for C
    over 16 or no power of two): the candidates of at most 64 hops, the
    plan's own layout."""
    _need_cuda()
    rng = np.random.default_rng(n + C)
    lanes = [lane for lane in _lanes(n, 2, rng)
             if sum(batchsim.compile_tape(lane.schedule).hops) <= 64]
    assert playback_kernel.launch_plan(n, C).cluster == cluster
    _same_as_plain_twice(_tapes(lanes, n, rng, "cuda"), _kw(n, C))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 5])
def test_cuda_playback_takes_any_offset_and_no_or_negative_hops(cluster):
    """Offsets far outside [0, n) both ways, hop counts of 0 and below, a lane
    that never hops: the plain version's bits."""
    _need_cuda()
    rng = np.random.default_rng(43 + cluster)
    n, B, S = 37, 5, 9
    hops = rng.integers(-3, 6, (B, S))
    hops[0] = 0
    arrays = (rng.uniform(1e3, 1e6, (B, S)), rng.integers(-5 * n, 5 * n, (B, S)), hops,
              rng.integers(0, 2, (B, S)).astype(bool), rng.uniform(0.0, 1e-3, B))
    t = [torch.from_numpy(a).to("cuda") for a in arrays]
    for C in (1, 3):
        _same_as_plain_twice(t, _kw(n, C), playback_kernel.launch_plan(n, C, cluster=cluster))


@pytest.mark.cuda
def test_cuda_refused_launch_raises():
    """A layout the card refuses (shared memory past the limit, a cluster of
    32) raises and counts no launch; there is no other path."""
    _need_cuda()
    rng = np.random.default_rng(3)
    t = _tapes(_lanes(12, 2, rng), 12, rng, "cuda")
    plan = playback_kernel.launch_plan(12, 4)
    before = playback_kernel.fabric_playback.launches
    for bad in (dataclasses.replace(plan, smem_bytes=playback_kernel.SMEM_LIMIT + 8),
                dataclasses.replace(plan, cluster=32, slots=1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            playback_kernel.fabric_playback(*t, **_kw(12, 4), _plan=bad)
    assert playback_kernel.fabric_playback.launches == before


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

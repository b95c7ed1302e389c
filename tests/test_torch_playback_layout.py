"""The layout of kernel B6 (the certified fabric playback) on the CPU.

`launch_plan` is the whole of the CUDA kernel's partition: the kernel takes
its cluster size, slots a CTA, threads and slots a thread as they are.  These
tests pin it without a card: every plan over a sweep of (n, C) fits the
card's limits and gives each slot to exactly one (CTA, thread), and a NumPy
emulation of the kernel's slot frame on that partition (`_emulate`: the
CTAs' ranges, each slot's push of its clock to slot (s - g) mod n as a
(rank, offset) of the owning CTA, the double-buffered clocks, the frame
offset and the ports put back in order at the end) gives the plain
version's bits.  No JAX here; the plain version's parity with the
reference is `tests/test_torch_fabric.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro_torch.core import PAPER_DEFAULT, batchsim, schedules  # noqa: E402
from repro_torch.kernels.playback import kernel as playback_kernel  # noqa: E402
from repro_torch.kernels.playback import ref as playback_ref  # noqa: E402
from repro_torch.kernels.playback.kernel import launch_plan  # noqa: E402

MB = 1024.0 ** 2
GRID = [(n, r) for n in (6, 12, 48, 96, 97) for r in (2, 3)]   # chip_smoke.PLAYBACK_GRID
# the plan's thresholds (the register kernels' CTAs fill at 4096, 2048 and
# 1024 slots; shared and device memory take over past 16 CTAs of them)
THRESHOLDS = [1, 2, 31, 32, 33, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096, 4097,
              16384, 16385, 25776, 25777, 32768, 32769, 46400, 46401, 65536, 65537, 70000]
SWEEP_NS = sorted(set(range(1, 70001, 263)) | set(THRESHOLDS))


def _ownership(plan, n):
    """(slot, rank, offset) of every (CTA, thread, i) that owns a slot, as the
    kernel walks them: CTA r's range starts at r * slots, thread t's i-th
    slot is t + i * threads of it."""
    rank, tid, i = np.meshgrid(np.arange(plan.cluster), np.arange(plan.threads),
                               np.arange(plan.spt), indexing="ij")
    loc = tid + i * plan.threads
    slot = rank * plan.slots + loc
    mine = (loc < plan.slots) & (slot < n)
    return slot[mine], rank[mine], loc[mine]


@pytest.mark.parametrize("C", range(1, 17))
def test_every_plan_fits_the_card_and_owns_each_slot_once(C):
    for n in SWEEP_NS:
        plan = launch_plan(n, C)
        assert 1 <= plan.cluster <= playback_kernel.MAX_CLUSTER
        assert plan.smem_bytes <= playback_kernel.SMEM_LIMIT
        assert plan.threads % 32 == 0 and 32 <= plan.threads
        bound = playback_kernel.REG_THREADS if plan.comp == "registers" \
            else playback_kernel.MEM_THREADS
        assert plan.threads <= bound
        assert plan.regs_estimate <= min(65536 // bound,
                                         playback_kernel.register_cap(plan.threads))
        if plan.comp == "registers":
            assert plan.spt == playback_kernel.REG_SLOTS[C]
        need = 16 * plan.slots + playback_kernel.SCRATCH_BYTES
        need += 8 * C * plan.slots if plan.comp == "shared" else 0
        assert plan.smem_bytes >= need and plan.slots < 2**16
        slot, _, _ = _ownership(plan, n)
        assert np.array_equal(np.sort(slot), np.arange(n)), (n, C, plan)
        # on chip, the fewest CTAs that hold the trains where they go; in
        # device memory, a slot a thread where 16 CTAs allow it
        if plan.comp == "global":
            assert plan.cluster == min(16, -(-n // 1024)) or plan.spt == 1
        elif plan.cluster > 1:
            assert playback_kernel._fit(n, C, plan.cluster - 1, plan.comp) is None


def test_plan_places_the_reference_shapes_as_designed():
    """The tiers and the planner's sets: trains in registers, on 1, 2, 8 and
    16 CTAs; past what registers hold, or at C no power of two up to 16,
    shared memory, then device memory."""
    want = {(1536, 4): (1, 192, "registers"), (8192, 2): (2, 512, "registers"),
            (32768, 2): (8, 512, "registers"), (1536, 8): (1, 384, "registers"),
            (32768, 8): (16, 512, "registers"), (20000, 16): (13, 1024, "shared"),
            (70000, 8): (16, 1024, "global"), (97, 20): (1, 128, "shared"),
            (1536, 3): (1, 1024, "shared")}
    for (n, C), (cluster, threads, comp) in want.items():
        plan = launch_plan(n, C)
        assert (plan.cluster, plan.threads, plan.comp) == (cluster, threads, comp), (n, C, plan)
    assert launch_plan(1536, 4, cluster=16).slots == 96
    assert launch_plan(12, 4, comp="global").comp == "global"
    with pytest.raises(ValueError, match="at most"):
        launch_plan(playback_kernel.MAX_PORTS + 1, 1)
    with pytest.raises(ValueError, match="cluster"):
        launch_plan(64, 2, cluster=17)
    with pytest.raises(ValueError, match="comp"):
        launch_plan(64, 2, comp="l2")
    with pytest.raises(ValueError, match="no layout"):
        launch_plan(64, 3, comp="registers")


def _emulate(nb, g, hops, changed, delta_eff, *, n, C, alpha_s, alpha_h, beta, plan):
    """The kernel's playback on `plan`'s partition, in NumPy float64 with the
    kernel's order of operations: the lanes longest first, each slot's train
    kept where it is for a step, only the clocks pushed each hop."""
    B, S = nb.shape
    K, L = plan.cluster, plan.slots
    slot, rank, loc = _ownership(plan, n)
    node_done, step_done, port_free = np.empty((B, n)), np.empty((B, S)), np.empty((B, n))
    order = np.argsort(-np.maximum(hops, 0).sum(1), kind="stable")
    for lane in order:
        xbuf = np.zeros((2, K, L))          # the clocks, double-buffered, by (rank, offset)
        train = np.zeros((slot.size, C))    # each slot's arrivals at its next port
        par, off, played, done = 0, 0, False, 0.0
        for k in range(S):
            chk, hk, gk = bool(changed[lane, k]), int(hops[lane, k]), int(g[lane, k]) % n
            if hk <= 0:
                if chk:
                    xbuf[par, rank, loc] = xbuf[par, rank, loc] + delta_eff[lane]
                step_done[lane, k] = done
                continue
            tau = (nb[lane, k] / C) * beta
            recv = train[:, C - 1] if played else np.zeros(slot.size)
            train[:] = (recv + alpha_s)[:, None]
            u = slot - gk
            u += np.where(u < 0, n, 0)
            to_rank, to_loc = u // L, u - (u // L) * L
            for j in range(hk):
                f = xbuf[par, rank, loc]
                if j == 0 and chk:
                    f = f + delta_eff[lane]
                for c in range(C):
                    f = np.maximum(f, train[:, c]) + tau
                    train[:, c] = f
                xbuf[par ^ 1, to_rank, to_loc] = f
                train = train + alpha_h
                par ^= 1
            played = True
            off = (off + hk * gk) % n
            step_done[lane, k] = done = train[:, C - 1].max()
        port = (slot + off) % n
        node_done[lane, port] = train[:, C - 1] if played else 0.0
        port_free[lane, port] = xbuf[par, rank, loc]
    return node_done, step_done, port_free


def _candidate_tapes(n, r, rng, keep=None):
    """The deduped a2a / rs / ag candidates at (n, r) with seeded payloads and
    a zero-payload lane, as numpy (nb, g, hops, changed, delta_eff);
    `keep(hops_of_lane)` picks lanes."""
    seen, scheds = set(), []
    for kind in ("a2a", "rs", "ag"):
        for _, sched in schedules.candidate_schedules(kind, n, 4 * MB, PAPER_DEFAULT, r=r):
            if (sched.kind, sched.x) not in seen:
                seen.add((sched.kind, sched.x))
                scheds.append(sched)
    tapes = [batchsim.compile_tape(s) for s in scheds]
    if keep is not None:
        tapes = [t for t in tapes if keep(t.arrays["hops"])]
    tapes.append(tapes[0])
    m = np.append(rng.uniform(0.05, 8.0, len(tapes) - 1) * MB, 0.0)
    nb = (m[:, None] * np.stack([t.arrays["counts"] for t in tapes])) / n
    ch = np.stack([t.arrays["changed_pay"] for t in tapes]).copy()
    ch[:, 0] = False
    return (nb, np.stack([t.arrays["g_step"] for t in tapes]),
            np.stack([t.arrays["hops"] for t in tapes]), ch,
            rng.uniform(0.0, 1e-3, len(tapes)))


def _assert_emulation_is_plain(tapes, n, C, plan):
    cm = PAPER_DEFAULT
    kw = {"n": n, "C": C, "alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h, "beta": cm.beta}
    got = _emulate(*tapes, plan=plan, **kw)
    want = playback_ref.fabric_playback(*(torch.from_numpy(np.ascontiguousarray(a))
                                          for a in tapes), **kw)
    for name, a, w in zip(("node_done", "step_done", "port_free"), got, want, strict=True):
        assert np.array_equal(a, w.numpy()), (name, n, C, plan)


@pytest.mark.parametrize("n,r", GRID)
def test_slot_frame_equals_plain_bit_for_bit_on_the_grid(n, r):
    """The grid's candidate sets, C in {1, 4, 8}, on the plan's own layout
    and on one forced to spread over 3 CTAs with shared-memory trains."""
    rng = np.random.default_rng(100 * n + r)
    tapes = _candidate_tapes(n, r, rng)
    for C in (1, 4, 8):
        _assert_emulation_is_plain(tapes, n, C, launch_plan(n, C))
    _assert_emulation_is_plain(tapes, n, 4, launch_plan(n, 4, cluster=3, comp="shared"))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_slot_frame_equals_plain_at_n1536_for_every_cluster(cluster):
    """n = 1536, C = 4 (the "jax" tier's), the candidates of at most 300 hops
    (its cap) and a zero-payload lane, on 1 to 16 CTAs: pushes that cross
    every CTA boundary."""
    rng = np.random.default_rng(1536 + cluster)
    tapes = _candidate_tapes(1536, 2, rng, keep=lambda h: h.sum() <= 300)
    _assert_emulation_is_plain(tapes, 1536, 4, launch_plan(1536, 4, cluster=cluster))


@pytest.mark.parametrize("cluster", [1, 3, 5, 16])
def test_slot_frame_takes_any_offset_and_no_or_negative_hops(cluster):
    """Offsets far outside [0, n) both ways, and hop counts of 0 and below
    (with the boundary charged where changed): n = 37 is no multiple of the
    CTAs or threads."""
    rng = np.random.default_rng(41 + cluster)
    n, C, B, S = 37, 3, 5, 9
    nb = rng.uniform(1e3, 1e6, (B, S))
    g = rng.integers(-5 * n, 5 * n, (B, S))
    hops = rng.integers(-3, 6, (B, S))
    hops[0] = 0                     # a lane that never hops
    ch = rng.integers(0, 2, (B, S)).astype(bool)
    de = rng.uniform(0.0, 1e-3, B)
    _assert_emulation_is_plain((nb, g, hops, ch, de), n, C, launch_plan(n, C, cluster=cluster))
    _assert_emulation_is_plain((nb, g, hops, ch, de), n, C,
                               launch_plan(n, C, cluster=cluster, comp="global"))


def test_auto_keeps_lanes_past_the_kernels_ports_on_numpy(monkeypatch):
    """`batch_run(backend="auto")` takes the card only for n the kernel
    holds on chip; `launch_plan` raises past it, so "torch" there raises."""
    from repro_torch.core import batchsim_torch
    monkeypatch.setattr(batchsim_torch, "cuda_available", lambda device=None: device is None)
    monkeypatch.setattr(batchsim, "_AUTO_MIN_WORK", 0)
    kw = {"certify": True, "certified": np.array([True]), "C": 8,
          "hops": np.array([[1, 2]])}
    big = playback_kernel.MAX_PORTS
    assert batchsim._resolve_backend("auto", n=big, **kw) == "torch"
    assert batchsim._resolve_backend("auto", n=big + 1, **kw) == "numpy"

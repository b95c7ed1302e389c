"""Port parity: the fabric simulator stack (`core/batchsim.py`, `fabricsim.py`,
`faults.py`, `eventsim.py`, `multiport.py`, `analysis/certifier.py`) and its
certified batch playback (kernel B6's plain version, `core/batchsim_torch.py`)
vs the reference.

The copies are held to the reference's text (up to the package name), the
changed ones outside the cuts each test names.  B6's plain version is held
bit for bit (float64, `np.array_equal`) to the reference's NumPy `_play` on a
grid of world sizes, radices, chunk counts and reconfiguration delays, and to
the reference's jitted XLA playback itself (`batchsim_jax._kernel()`, run
under `jax.enable_x64(True)`: `play_certified` around it imports what jax
0.9.0 no longer has).  `batch_run`, the certifier, the scalar engines, the
fault timelines and the planner's ``fabric="ocs-sim"`` scoring are held to
the reference's answers exactly (the same float operations in the same
order).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
jax = pytest.importorskip("jax")

from repro.analysis import certifier as ref_certifier  # noqa: E402
from repro.core import PAPER_DEFAULT as REF_CM  # noqa: E402
from repro.core import batchsim as ref_batchsim  # noqa: E402
from repro.core import batchsim_jax as ref_batchsim_jax  # noqa: E402
from repro.core import eventsim as ref_eventsim  # noqa: E402
from repro.core import fabricsim as ref_fabricsim  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.core import multiport as ref_multiport  # noqa: E402
from repro.core import schedules as ref_schedules  # noqa: E402
from repro.core.jsonio import FabricKind as RefFabricKind  # noqa: E402
from repro.planner import Planner as RefPlanner  # noqa: E402
from repro.planner import PlanRequest as RefPlanRequest  # noqa: E402
from repro.planner import default_planner as ref_default_planner  # noqa: E402
from repro_torch import core as port_core  # noqa: E402
from repro_torch.analysis import certifier  # noqa: E402
from repro_torch.core import PAPER_DEFAULT  # noqa: E402
from repro_torch.core import batchsim, eventsim, fabricsim, faults, multiport  # noqa: E402
from repro_torch.core import batchsim_torch, schedules  # noqa: E402
from repro_torch.core.jsonio import FabricKind  # noqa: E402
from repro_torch.kernels.playback import kernel as playback_kernel  # noqa: E402
from repro_torch.planner import Planner, PlanRequest, default_planner  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MB = 1024.0 ** 2
KINDS = ("a2a", "rs", "ag")
GRID = [(n, r) for n in (6, 12, 48, 96) for r in (2, 3)]
# the (C, delta) the XLA kernel holds per (n, r): it compiles once a shape
JAX_POINT = {2: (4, 1e-3), 3: (1, 0.0)}

WHOLE_COPIES = ["core/eventsim.py", "core/multiport.py", "core/fabricsim.py",
                "core/faults.py", "analysis/__init__.py", "analysis/certifier.py",
                "analysis/violations.py", "analysis/verifier.py", "analysis/mutations.py",
                "checkpoint/__init__.py", "workloads/__init__.py",
                "workloads/trace_planner.py", "workloads/online_planner.py",
                "workloads/serve.py", "workloads/tenancy.py", "workloads/recovery.py"]
# (start, end) markers, in order: the text from each start up to its end (or
# the file's end) is what the port changed; the rest equals the reference
CUTS = {
    "workloads/traces.py": {
        "_arch reads the port's configs": ("    from repro", "  # deferred: keep workloads"),
    },
    "core/batchsim.py": {
        "the module docstring's backends: numpy, torch, auto": (
            "  - ``\"numpy\"`` (default): the `_play` loop", '"""\nfrom __future__'),
        "BatchFabricResult.backend names torch": (
            "    backend is the resolved playback engine", '    """\n\n    completion:'),
        "_AUTO_MIN_WORK and _resolve_backend": ('# "auto" switches to', "def batch_run("),
        "batch_run takes device": ('backend: str = "numpy"', ") -> BatchFabricResult:"),
        "batch_run's docstring on backends": (
            "    ``backend`` selects the playback engine", "    lanes = tuple(lanes)"),
        "batch_run's torch branch": (
            "    backend = _resolve_backend(", "        B = len(lanes)"),
        "play_certified gets device": ("delta_eff=delta_eff[jidx]", "        node_done[jidx]"),
        "batch_completion_times takes and forwards device": (
            '                           backend: str = "numpy"', None),
    },
}


def _src(pkg: str, path: str) -> str:
    return (SRC / pkg / path).read_text().replace("repro_torch.", "repro.")


def _cut(text: str, cuts) -> str:
    at, out = 0, []
    for start, end in cuts:
        a = text.index(start, at)
        out.append(text[at:a])
        at = len(text) if end is None else text.index(end, a)
    return "".join(out) + text[at:]


@pytest.mark.parametrize("path", WHOLE_COPIES)
def test_whole_copies_equal_reference(path):
    assert _src("repro_torch", path) == _src("repro", path)


@pytest.mark.parametrize("path", list(CUTS))
def test_cut_copies_equal_reference_outside_their_cuts(path):
    cuts = list(CUTS[path].values())
    port, ref = _src("repro_torch", path), _src("repro", path)
    assert _cut(port, cuts) == _cut(ref, cuts)


def test_core_exports_the_references_less_the_tpu_preset():
    from repro import core as ref_core
    want = set(ref_core.__all__) - {"TPU_V5E"} | {"H100_NVLINK"}
    assert set(port_core.__all__) == want
    assert all(hasattr(port_core, name) for name in want)


# --- B6's plain version vs the reference's two playbacks -----------------------------


def _candidates(core_schedules, n: int, r: int, cm):
    """The deduped a2a / rs / ag candidate set at (n, r): one (n, S) batch."""
    seen, out = set(), []
    for kind in KINDS:
        for _, sched in core_schedules.candidate_schedules(kind, n, 4 * MB, cm, r=r):
            if (sched.kind, sched.x) not in seen:
                seen.add((sched.kind, sched.x))
                out.append(sched)
    return out


def _tapes(batchsim_mod, scheds, m, n):
    """The [B, S] stacks batch_run builds, from `batchsim_mod`'s compile_tape."""
    tapes = [batchsim_mod.compile_tape(s) for s in scheds]
    nb = (m[:, None] * np.stack([t.arrays["counts"] for t in tapes])) / n
    g = np.stack([t.arrays["g_step"] for t in tapes])
    h = np.stack([t.arrays["hops"] for t in tapes])
    ch = np.stack([t.arrays["changed_pay"] for t in tapes]).copy()
    ch[:, 0] = False
    return nb, g, h, ch


def _plain(nb, g, h, ch, de, n, C, cm):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (nb, g, h, ch, de)]
    before = playback_kernel.fabric_playback.launches
    out = playback_kernel.fabric_playback(*t, n=n, C=C, alpha_s=cm.alpha_s,
                                          alpha_h=cm.alpha_h, beta=cm.beta)
    assert playback_kernel.fabric_playback.launches == before  # a CPU call never counts
    return [o.numpy() for o in out]


@pytest.mark.parametrize("n,r", GRID)
def test_plain_playback_equals_numpy_play_and_the_xla_kernel(n, r):
    """Every candidate of (n, r) with seeded payloads and a zero-payload
    lane: the same bits as `_play(check_order=False)` for C in {1, 4} and
    delta in {0, 1 ms}, and as the XLA kernel at one (C, delta)."""
    rng = np.random.default_rng(1000 * n + r)
    scheds = _candidates(ref_schedules, n, r, REF_CM)
    port_scheds = _candidates(schedules, n, r, PAPER_DEFAULT)
    assert [(s.kind, s.x) for s in port_scheds] == [(s.kind, s.x) for s in scheds]
    scheds.append(scheds[0])
    m = np.append(rng.uniform(0.05, 8.0, len(scheds) - 1) * MB, 0.0)  # a zero-payload lane
    nb, g, h, ch = _tapes(ref_batchsim, scheds, m, n)
    for got, want in zip(_tapes(batchsim, port_scheds + port_scheds[:1], m, n), (nb, g, h, ch),
                         strict=True):
        assert np.array_equal(got, want)
    B = len(scheds)
    for C in (1, 4):
        for delta in (0.0, 1e-3):
            cm = REF_CM.replace(delta=delta)
            de = np.full(B, delta) * (1.0 - rng.uniform(0.0, 1.0, B).round(2))
            want = ref_batchsim._play(
                n=n, C=C, cm=cm, nb_step=nb, g_step=g, hops=h,
                boundary=np.zeros_like(ch), changed=ch, delta_eff=de, speed=np.ones((B, n)),
                scale=None, check_order=False)
            got = _plain(nb, g, h, ch, de, n, C, cm)
            for gi, wi in zip(got, (want[0], want[1], want[3]), strict=True):
                assert gi.dtype == np.float64 and np.array_equal(gi, wi), (C, delta)
            if (C, delta) == JAX_POINT[r]:
                with jax.enable_x64(True):
                    xla = ref_batchsim_jax._kernel()(nb, g, h, ch, de, cm.alpha_s, cm.alpha_h,
                                                     cm.beta, n=n, C=C)
                    xla = [np.asarray(a) for a in xla]
                for gi, wi in zip(got, xla, strict=True):
                    assert np.array_equal(gi, wi), (C, delta)


def test_plain_playback_takes_pythons_modulo_for_any_offset():
    """g outside [0, n) (negative, or n and more) gathers from (p - g) mod n,
    as the reference's `%` does."""
    rng = np.random.default_rng(5)
    n, C, B, S = 7, 3, 4, 3
    nb = rng.uniform(1e3, 1e6, (B, S))
    h = rng.integers(0, 4, (B, S))
    ch = rng.integers(0, 2, (B, S)).astype(bool)
    ch[:, 0] = False
    de = rng.uniform(0.0, 1e-3, B)
    base = rng.integers(0, n, (B, S))
    want = _plain(nb, base, h, ch, de, n, C, REF_CM)
    for g in (base - 3 * n, base + 2 * n):
        assert all(np.array_equal(a, b) for a, b in
                   zip(_plain(nb, g, h, ch, de, n, C, REF_CM), want, strict=True))


# --- batch_run: the torch backend (plain version on the CPU) vs the reference --------


FIELDS = ("completion", "node_done", "step_done", "chunks_moved", "reconfigs_paid",
          "delta_stall", "certified", "fast_path")


def _mixed_lanes(mod, n: int, r: int, sched_mod, cm, rng):
    """Certified candidate lanes with seeded payloads / deltas / overlaps,
    then uncertified ones: a skewed link_speed, a skewed payload_scale and a
    severe straggler (whose guard trips: the scalar oracle)."""
    scheds = _candidates(sched_mod, n, r, cm)
    lanes = [mod.BatchLane(schedule=s, m_bytes=float(m), delta=float(d), overlap=float(o))
             for s, m, d, o in zip(scheds, rng.uniform(0.1, 4.0, len(scheds)) * MB,
                                   rng.choice([0.0, 1e-6, 1e-3], len(scheds)),
                                   rng.choice([0.0, 0.5], len(scheds)), strict=True)]
    speed = tuple(float(v) for v in rng.uniform(0.5, 1.5, n))
    scale = tuple(float(v) for v in rng.uniform(0.5, 2.0, n))
    lanes += [mod.BatchLane(schedule=scheds[0], m_bytes=MB, link_speed=speed),
              mod.BatchLane(schedule=scheds[-1], m_bytes=2 * MB, payload_scale=scale),
              mod.BatchLane(schedule=scheds[1], m_bytes=2 * MB,
                            link_speed=tuple(fabricsim.straggler_speeds(n, {3: 1e-4})))]
    return lanes


@pytest.mark.parametrize("n,r", [(6, 2), (12, 3), (48, 2)])
def test_batch_run_torch_backend_equals_reference(n, r):
    rng_a, rng_b = np.random.default_rng(n + r), np.random.default_rng(n + r)
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    ref_lanes = _mixed_lanes(ref_batchsim, n, r, ref_schedules, REF_CM.replace(delta=1e-3), rng_a)
    lanes = _mixed_lanes(batchsim, n, r, schedules, cm, rng_b)
    for C in (1, 4):
        want = ref_batchsim.batch_run(ref_lanes, REF_CM.replace(delta=1e-3), chunks_per_msg=C)
        got = batchsim.batch_run(lanes, cm, chunks_per_msg=C, backend="torch", device="cpu")
        assert got.backend == "torch" and want.backend == "numpy"
        for field in FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        # routing: the certified lanes are the reference's partition, and the
        # severe straggler took the scalar oracle
        jidx, uidx, mask = ref_certifier.partition_backends(ref_lanes, REF_CM.replace(delta=1e-3))
        assert np.array_equal(got.certified, mask) and len(uidx) == 3 and len(jidx) >= 1
        assert not got.fast_path[-1]
        for b in range(len(lanes)):
            assert dataclasses.asdict(got.result(b)) == dataclasses.asdict(want.result(b))


def test_batch_completion_times_torch_equals_reference_numpy():
    for n, r in ((12, 2), (96, 2)):
        want_scheds = _candidates(ref_schedules, n, r, REF_CM)
        got_scheds = _candidates(schedules, n, r, PAPER_DEFAULT)
        for overlap in (0.0, 0.75):
            want = ref_batchsim.batch_completion_times(want_scheds, 3 * MB, REF_CM,
                                                       overlap=overlap, chunks_per_msg=8)
            got = batchsim.batch_completion_times(got_scheds, 3 * MB, PAPER_DEFAULT,
                                                  overlap=overlap, chunks_per_msg=8,
                                                  backend="torch", device="cpu")
            assert np.array_equal(got, want)


# --- the other modules of the slice vs the reference --------------------------------


def _trace_lanes(mod, sched_mod, n, rng):
    scheds = _candidates(sched_mod, n, 2, REF_CM if mod is ref_batchsim else PAPER_DEFAULT)
    by_kind = {kind: [s for s in scheds if s.kind == kind] for kind in KINDS}
    out = []
    for i in range(4):
        phases = tuple((by_kind[k][(i + j) % len(by_kind[k])], float(m))
                       for j, (k, m) in enumerate(zip(("rs", "ag", "a2a"),
                                                      rng.uniform(0.1, 2.0, 3) * MB,
                                                      strict=True)))
        out.append(mod.TraceLane(phases=phases, delta=[0.0, 1e-3][i % 2],
                                 overlap=[0.0, 0.5][i // 2]))
    out.append(mod.TraceLane(phases=out[0].phases,
                             link_speed=tuple(float(v) for v in rng.uniform(0.6, 1.4, n))))
    return out


@pytest.mark.parametrize("n", [6, 12, 24])
def test_certifier_masks_equal_reference(n):
    rng_a, rng_b = np.random.default_rng(n), np.random.default_rng(n)
    for cm_ref, cm in ((REF_CM, PAPER_DEFAULT),
                       (REF_CM.replace(alpha_h=0.0), PAPER_DEFAULT.replace(alpha_h=0.0)),
                       (REF_CM.replace(alpha_s=0.0), PAPER_DEFAULT.replace(alpha_s=0.0))):
        want = ref_certifier.certify_batch(
            _mixed_lanes(ref_batchsim, n, 2, ref_schedules, cm_ref, rng_a), cm_ref)
        got = certifier.certify_batch(_mixed_lanes(batchsim, n, 2, schedules, cm, rng_b), cm)
        assert np.array_equal(got, want)
        want = ref_certifier.certify_trace_batch(
            _trace_lanes(ref_batchsim, ref_schedules, n, rng_a), cm_ref)
        got = certifier.certify_trace_batch(_trace_lanes(batchsim, schedules, n, rng_b), cm)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["sparse", "full-pause", "batched"])
def test_fabric_sim_equals_reference(mode):
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    for n in (6, 12):
        speed = fabricsim.straggler_speeds(n, {1: 0.5})
        for want_s, got_s in zip(_candidates(ref_schedules, n, 2, REF_CM)[:6],
                                 _candidates(schedules, n, 2, PAPER_DEFAULT)[:6], strict=True):
            for kw in ({}, {"link_speed": speed}):
                want = ref_fabricsim.FabricSim(chunks_per_msg=4, mode=mode, **kw).run(
                    want_s, 2 * MB, cm_ref)
                got = fabricsim.FabricSim(chunks_per_msg=4, mode=mode, **kw).run(
                    got_s, 2 * MB, cm)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _phases(sched_mod, n, k=3):
    return tuple((sched_mod.static_schedule("a2a", n, 2), (i + 1) * MB) for i in range(k))


def test_run_trace_with_carryover_and_snapshots_equals_reference():
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    n = 12
    mixed = lambda mod: (mod.periodic_a2a(n, 2), mod.static_schedule("rs", n, 2),  # noqa: E731
                         mod.every_step_schedule("ag", n, 2))
    for mode in ("sparse", "batched", "full-pause"):
        want_phases = tuple((s, (i + 1) * MB) for i, s in enumerate(mixed(ref_schedules)))
        got_phases = tuple((s, (i + 1) * MB) for i, s in enumerate(mixed(schedules)))
        kw = {} if mode == "full-pause" else {"capture_state": True}
        want = ref_fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(
            want_phases, cm_ref, **kw)
        got = fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(got_phases, cm, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if mode != "full-pause":  # resume the suffix from the prefix's snapshot
            want_pre = ref_fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(
                want_phases[:1], cm_ref, capture_state=True).final_state
            got_pre = fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(
                got_phases[:1], cm, capture_state=True).final_state
            assert dataclasses.asdict(got_pre) == dataclasses.asdict(want_pre)
            want = ref_fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(
                want_phases[1:], cm_ref, initial=want_pre)
            got = fabricsim.FabricSim(chunks_per_msg=4, mode=mode).run_trace(
                got_phases[1:], cm, initial=got_pre)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            tree = faults.snapshot_to_tree(got_pre)
            assert faults.tree_to_snapshot(tree) == got_pre


@pytest.mark.parametrize("kind", ["link-down", "link-flap", "node-leave", "node-join"])
def test_run_trace_with_a_fault_timeline_equals_reference(kind):
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    n = 12
    clean = fabricsim.FabricSim(chunks_per_msg=4).run_trace(_phases(schedules, n), cm)
    t_f = 0.5 * (clean.phase_done[0] + clean.phase_done[1])
    node = n if kind == "node-join" else 5
    repair = 0.25 * clean.completion if kind == "link-flap" else 0.0
    for policy in ("drop", "requeue"):
        want_tl = ref_faults.FaultTimeline(n=n, policy=policy, faults=(
            ref_faults.FaultSpec(kind=kind, time=t_f, node=node, repair_s=repair),))
        got_tl = faults.FaultTimeline(n=n, policy=policy, faults=(
            faults.FaultSpec(kind=kind, time=t_f, node=node, repair_s=repair),))
        assert got_tl.to_json() == want_tl.to_json()
        want = ref_fabricsim.FabricSim(chunks_per_msg=4).run_trace(
            _phases(ref_schedules, n), cm_ref, faults=want_tl, capture_state=True)
        got = fabricsim.FabricSim(chunks_per_msg=4).run_trace(
            _phases(schedules, n), cm, faults=got_tl, capture_state=True)
        assert got.degraded is not None
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.degraded.new_n == want.degraded.new_n
        assert got.degraded.dead_port_mask() == want.degraded.dead_port_mask()
    want_tl = ref_faults.random_timeline(n, horizon_s=clean.completion, seed=3, count=2)
    got_tl = faults.random_timeline(n, horizon_s=clean.completion, seed=3, count=2)
    assert got_tl.to_json() == want_tl.to_json()
    for f in got_tl.faults:
        assert faults.world_after(n, f) == ref_faults.world_after(n, ref_faults.FaultSpec(
            **f.to_dict()))


def test_batch_run_trace_equals_reference():
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    n = 12
    want_lanes = _trace_lanes(ref_batchsim, ref_schedules, n, rng_a)
    got_lanes = _trace_lanes(batchsim, schedules, n, rng_b)
    clean = fabricsim.FabricSim(chunks_per_msg=4).run_trace(got_lanes[0].phases,
                                                            cm.replace(delta=0.0))
    snap_w = ref_fabricsim.FabricSim(chunks_per_msg=4).run_trace(
        want_lanes[1].phases[:1], cm_ref, capture_state=True).final_state
    snap_g = fabricsim.FabricSim(chunks_per_msg=4).run_trace(
        got_lanes[1].phases[:1], cm, capture_state=True).final_state
    t_f = 0.5 * (clean.phase_done[0] + clean.phase_done[1])
    want_lanes += [
        ref_batchsim.TraceLane(phases=want_lanes[1].phases, initial=snap_w),
        ref_batchsim.TraceLane(phases=want_lanes[0].phases, faults=ref_faults.FaultTimeline(
            n=n, faults=(ref_faults.FaultSpec(kind="link-down", time=t_f, node=2),)))]
    got_lanes += [
        batchsim.TraceLane(phases=got_lanes[1].phases, initial=snap_g),
        batchsim.TraceLane(phases=got_lanes[0].phases, faults=faults.FaultTimeline(
            n=n, faults=(faults.FaultSpec(kind="link-down", time=t_f, node=2),)))]
    want = ref_batchsim.batch_run_trace(want_lanes, cm_ref, chunks_per_msg=4)
    got = batchsim.batch_run_trace(got_lanes, cm, chunks_per_msg=4)
    for field in FIELDS + ("phase_done", "port_free"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert got.degraded[-1] is not None
    for b in range(len(got_lanes)):
        assert dataclasses.asdict(got.result(b)) == dataclasses.asdict(want.result(b))


def test_eventsim_and_multiport_equal_reference():
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    for n in (6, 12, 16):
        for want_s, got_s in zip(_candidates(ref_schedules, n, 2, REF_CM)[:5],
                                 _candidates(schedules, n, 2, PAPER_DEFAULT)[:5], strict=True):
            for chunks in (1, 8):
                assert eventsim.collective_time_event(got_s, MB, cm, chunks) == \
                    ref_eventsim.collective_time_event(want_s, MB, cm_ref, chunks)
        assert eventsim.ring_allreduce_event(n, MB, cm) == \
            ref_eventsim.ring_allreduce_event(n, MB, cm_ref)
        for p in (1, 2, 3):
            assert multiport.num_steps_multiport(n, p) == ref_multiport.num_steps_multiport(n, p)
            for every in (0, 1, 2):
                assert dataclasses.asdict(multiport.a2a_multiport_time(n, MB, p, cm, every)) == \
                    dataclasses.asdict(ref_multiport.a2a_multiport_time(n, MB, p, cm_ref, every))


# --- the slice as a whole: the planner's ocs-sim scoring ------------------------------


def _alts(res):
    return [(a.strategy, a.predicted_time, a.R, a.x) for a in res.alternatives]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [8, 12, 96])
def test_ocs_sim_plans_equal_reference(kind, n):
    """The port's ocs-sim plan (NumPy scoring) equals the reference's, and the
    torch backend (plain version on the CPU) gives the same scores."""
    ref_cm = REF_CM.replace(delta=1e-3)
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    want = RefPlanner(sim_backend="numpy", verify=False).plan(RefPlanRequest(
        kind=kind, n=n, m_bytes=4 * MB, cost_model=ref_cm, fabric=RefFabricKind.OCS_SIM,
        overlap=0.25))
    got = Planner(sim_backend="numpy").plan(PlanRequest(
        kind=kind, n=n, m_bytes=4 * MB, cost_model=cm, fabric=FabricKind.OCS_SIM, overlap=0.25))
    assert (got.schedule.kind, got.schedule.x) == (want.schedule.kind, want.schedule.x)
    assert (got.strategy, got.predicted_time) == (want.strategy, want.predicted_time)
    assert _alts(got) == _alts(want)
    planner = Planner(sim_backend="numpy")
    cands = list(planner._candidates(got.request, kind))
    scores = planner._sim_scores(got.request, cands)
    on_cpu = batchsim.batch_completion_times(
        [cands[i].schedule for i in scores], 4 * MB, cm, overlap=0.25,
        chunks_per_msg=planner.sim_chunks, backend="torch", device="cpu")
    assert len(scores) > 1 and np.array_equal(on_cpu, list(scores.values()))


def test_ocs_sim_default_planner_equals_reference():
    """The request that raised before the fabric stack was ported (moved from
    test_torch_planner.py): the default planners agree."""
    got = default_planner().plan(PlanRequest(kind="rs", n=8, m_bytes=1e6,
                                             fabric=FabricKind.OCS_SIM))
    want = ref_default_planner().plan(RefPlanRequest(kind="rs", n=8, m_bytes=1e6,
                                                     fabric=RefFabricKind.OCS_SIM))
    assert (got.schedule.x, got.strategy, got.predicted_time) == \
        (want.schedule.x, want.strategy, want.predicted_time)
    assert _alts(got) == _alts(want)


# --- behaviour pins -------------------------------------------------------------------


def _lanes(n=12):
    return [batchsim.BatchLane(schedule=schedules.periodic_a2a(n, R), m_bytes=(R + 1) * MB)
            for R in range(3)]


def test_torch_backend_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batchsim.batch_run(_lanes(), cm, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Planner(sim_backend="torch").plan(PlanRequest(kind="rs", n=12, m_bytes=MB,
                                                      fabric=FabricKind.OCS_SIM))
    res = batchsim.batch_run(_lanes(), cm, backend="torch", device="cpu")
    assert res.backend == "torch" and res.certified.all()
    # "auto" stays on NumPy without a card, and when the CPU is asked for
    assert batchsim.batch_run(_lanes(), cm, backend="auto").backend == "numpy"
    assert not batchsim_torch.cuda_available() and not batchsim_torch.cuda_available("cpu")


def test_backend_resolution():
    cm = PAPER_DEFAULT.replace(delta=1e-3)
    with pytest.raises(ValueError, match="backend='torch'"):
        batchsim.batch_run(_lanes(), cm, backend="jax")
    with pytest.raises(ValueError, match="requires certify=True"):
        batchsim.batch_run(_lanes(), cm, backend="torch", certify=False, device="cpu")
    with pytest.raises(ValueError, match="backend must be"):
        batchsim.batch_run(_lanes(), cm, backend="xla")
    with pytest.raises(ValueError, match="sim_backend must be"):
        Planner(sim_backend="jax")
    # no certified lane: "torch" degrades to NumPy, as "jax" does in the reference
    skew = [dataclasses.replace(lane, link_speed=tuple([0.5] + [1.0] * 11)) for lane in _lanes()]
    assert batchsim.batch_run(skew, cm, backend="torch", device="cpu").backend == "numpy"
    hops = np.ones((3, 4), dtype=np.int64)
    cert = np.ones(3, dtype=bool)
    kw = {"certify": True, "certified": cert, "n": 12, "C": 8, "hops": hops}
    assert batchsim._resolve_backend("auto", device="cpu", **kw) == "numpy"
    if not torch.cuda.is_available():
        assert batchsim._resolve_backend("auto", **kw) == "numpy"


def test_auto_takes_the_card_above_the_work_floor(monkeypatch):
    monkeypatch.setattr(batchsim_torch, "cuda_available", lambda device=None: device is None)
    cert = np.array([True, False])
    hops = np.array([[3, 4], [100, 100]])
    work = 8 * 12 * 7  # only the certified lane's hops count
    kw = {"certify": True, "certified": cert, "n": 12, "C": 8, "hops": hops}
    monkeypatch.setattr(batchsim, "_AUTO_MIN_WORK", work)
    assert batchsim._resolve_backend("auto", **kw) == "torch"
    assert batchsim._resolve_backend("auto", device="cpu", **kw) == "numpy"
    monkeypatch.setattr(batchsim, "_AUTO_MIN_WORK", work + 1)
    assert batchsim._resolve_backend("auto", **kw) == "numpy"


def test_checkpointed_paths_raise_naming_a11(tmp_path):
    """`run_trace(checkpoint_dir=...)` through the port's store (the sparse
    engine): the straight run's result, the reference's checkpointed result,
    the same snapshot files (each package's `latest_snapshot` reads the
    other's directory)."""
    _checkpointed_paths_equal(tmp_path, "sparse")


def test_checkpointed_batched_path_equals_the_straight_run_and_the_reference(tmp_path):
    _checkpointed_paths_equal(tmp_path, "batched")


def _checkpointed_paths_equal(tmp_path, mode):
    cm_ref, cm = REF_CM.replace(delta=1e-3), PAPER_DEFAULT.replace(delta=1e-3)
    phases, ref_phases = _phases(schedules, 12, k=4), _phases(ref_schedules, 12, k=4)
    straight = fabricsim.FabricSim(mode=mode, chunks_per_msg=4).run_trace(
        phases, cm, capture_state=True)
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    got = fabricsim.FabricSim(mode=mode, chunks_per_msg=4).run_trace(
        phases, cm, capture_state=True, checkpoint_dir=port_dir, checkpoint_every=2)
    want = ref_fabricsim.FabricSim(mode=mode, chunks_per_msg=4).run_trace(
        ref_phases, cm_ref, capture_state=True, checkpoint_dir=ref_dir, checkpoint_every=2)
    for field in ("completion", "phase_done", "step_done", "chunks_moved", "reconfigs_paid",
                  "delta_stall"):
        assert getattr(got, field) == getattr(straight, field) == getattr(want, field), field
    snap = dataclasses.asdict(straight.final_state)
    assert dataclasses.asdict(got.final_state) == dataclasses.asdict(want.final_state) == snap
    assert faults.latest_snapshot(port_dir) == straight.final_state
    assert faults.latest_snapshot(ref_dir) == straight.final_state
    assert ref_faults.latest_snapshot(port_dir) == want.final_state
    assert faults.latest_snapshot(str(tmp_path / "empty")) is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    nb = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    args = (nb, nb.long(), nb.long(), nb.bool(), torch.zeros(2, dtype=torch.float64,
                                                             device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        playback_kernel.fabric_playback(*args, n=4, C=2, alpha_s=0.0, alpha_h=0.0, beta=1.0)
    with pytest.raises(ValueError, match="outside int32"):
        playback_kernel._int32("g", torch.tensor([-2**31 - 1, 2]))
    with pytest.raises(ValueError, match="outside int32"):
        playback_kernel._int32("hops", torch.tensor([2**31]))
    with pytest.raises(ValueError, match="int32 or int64"):
        playback_kernel._int32("hops", torch.tensor([1.0]))
    got = playback_kernel._int32("g", torch.tensor([-5, 2**31 - 1]))
    assert got.dtype == torch.int32 and got.tolist() == [-5, 2**31 - 1]

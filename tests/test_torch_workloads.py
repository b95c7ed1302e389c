"""Port parity: the workload planners (`repro_torch/workloads/`) vs the
reference, bit for bit.

The modules are copies of the reference's (held to its text in
tests/test_torch_fabric.py; `traces.py` reads the port's configs).  The same
inputs go through both packages in one process and every result must be
equal exactly (`to_dict()` of plans and served plans, the stats, the
recovery totals and states): trace planning in every mode and on both
analytic fabrics, online planning over several windows, the plan service's
request storm (hit accounting and plan-sequence signature), shared planning
in both sharing modes, and fault recovery for every fault kind, on grid
points of the reference's benches (benchmarks/trace_bench.py,
online_bench.py, tenancy_bench.py, faults_bench.py).  The committed
BENCH_*.json rows are held by chip_smoke.py's phase 11 (at 1e-12 relative):
today's reference re-derives them only to the last ulp.
"""
import dataclasses
import warnings

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro import workloads as ref  # noqa: E402
from repro.core import PAPER_DEFAULT as REF_CM  # noqa: E402
from repro.core import FabricSim as RefFabricSim  # noqa: E402
from repro.core.faults import FaultSpec as RefFaultSpec  # noqa: E402
from repro.core.faults import FaultTimeline as RefFaultTimeline  # noqa: E402
from repro.core.jsonio import FabricKind as RefFabricKind  # noqa: E402
from repro_torch import workloads as port  # noqa: E402
from repro_torch.core import PAPER_DEFAULT, FabricSim  # noqa: E402
from repro_torch.core.faults import FaultSpec, FaultTimeline  # noqa: E402
from repro_torch.core.jsonio import FabricKind  # noqa: E402

# each package: (module, cost model, FabricSim, FaultSpec, FaultTimeline, FabricKind)
PORT = (port, PAPER_DEFAULT, FabricSim, FaultSpec, FaultTimeline, FabricKind)
REF = (ref, REF_CM, RefFabricSim, RefFaultSpec, RefFaultTimeline, RefFabricKind)
TRACES = ("moe", "train", "decode", "mixed")
FAULT_KINDS = ("link-down", "link-flap", "node-leave", "node-join")


def _trace(w, name: str, n: int, seed: int = 0):
    """benchmarks/trace_bench.py's make_trace."""
    return {"moe": lambda: w.moe_a2a_trace(n, layers=3, seed=seed),
            "train": lambda: w.train_step_trace(n, steps=2, buckets=2, seed=seed),
            "decode": lambda: w.decode_ag_trace(n, decode_steps=6, seed=seed, jitter=0.25),
            "mixed": lambda: w.mixed_trace(n, seed=seed)}[name]()


def _both(fn):
    """fn(package) for the port and the reference."""
    return fn(PORT), fn(REF)


def test_workloads_export_the_references():
    assert port.__all__ == ref.__all__
    assert all(hasattr(port, name) for name in port.__all__)


@pytest.mark.parametrize("name", TRACES)
def test_traces_equal_the_references(name):
    got, want = _both(lambda pk: _trace(pk[0], name, 48, seed=3).to_dict())
    assert got == want
    got, want = _both(lambda pk: pk[0].approx_param_bytes(
        pk[0].traces._arch("qwen3-moe-235b-a22b")))
    assert got == want


@pytest.mark.parametrize("name", TRACES)
@pytest.mark.parametrize("delta", [10e-6, 15e-3])
def test_plan_trace_equals_the_reference_in_every_mode(name, delta):
    def plans(pk):
        w, cm = pk[0], pk[1].replace(delta=delta)
        trace = _trace(w, name, 16)
        out = [w.plan_trace(trace, cm, mode=mode).to_dict() for mode in w.TRACE_PLAN_MODES]
        out.append(w.plan_trace(trace, cm, mode="carryover", delta_budget=4 * delta)
                   .to_dict())
        out.append(w.plan_trace(trace, cm, mode="carryover", fabric=pk[5].OCS_OVERLAP,
                                overlap=0.5).to_dict())
        return out

    got, want = _both(plans)
    assert got == want


def test_carryover_execution_equals_the_reference():
    def run(pk):
        w, cm, sim = pk[0], pk[1].replace(delta=1e-3), pk[2]
        carry = w.plan_trace(_trace(w, "mixed", 16), cm, mode="carryover")
        res = sim(chunks_per_msg=4, mode="batched").run_trace(carry.fabric_phases(), cm)
        return res.completion, res.phase_done, res.chunks_moved

    got, want = _both(run)
    assert got == want


@pytest.mark.parametrize("name", ["mixed", "moe", "decode"])
@pytest.mark.parametrize("window", [1, 2, 4])
def test_run_online_equals_the_reference(name, window):
    def online(pk):
        w, cm = pk[0], pk[1].replace(delta=1e-3)
        plan, stats = w.run_online(_trace(w, name, 16), cm, window=window)
        return plan.to_dict(), dataclasses.astuple(stats)

    got, want = _both(online)
    assert got == want


def test_plan_service_storm_equals_the_reference():
    """online_bench's storm: the same hits, misses, windows and plan-sequence
    signature (sha256 over every served plan's JSON), cold and hot."""
    def storm(pk):
        w = pk[0]
        pool = w.build_request_pool(16, window=3, seed=0)
        service = w.PlanService()
        out = []
        for seed in (1, 2):
            s = w.request_storm(service, pool, requests=256, seed=seed)
            out.append((s.requests, s.hits, s.misses, s.unique_windows, s.signature))
        served = service.serve(pool[5]).to_dict()
        return out, served, tuple(service.cache_info())

    got, want = _both(storm)
    assert got == want
    assert got[0][1][2] == 0  # the hot storm is served from the LRU


@pytest.mark.parametrize("sharing", ["time-slice", "port-partition"])
@pytest.mark.parametrize("K", [2, 3])
def test_plan_shared_equals_the_reference(sharing, K):
    """tenancy_bench's tenants (its make_tenants) on one 48-port fabric."""
    def shared(pk):
        w, cm = pk[0], pk[1].replace(delta=1e-3)
        world = 48 if sharing == "time-slice" else 48 // K
        gens = (lambda n, s: w.mixed_trace(n, seed=s),
                lambda n, s: w.decode_ag_trace(n, decode_steps=4, seed=s, jitter=0.25),
                lambda n, s: w.moe_a2a_trace(n, layers=2, seed=s))
        tenants = tuple(w.TenantSpec(name=f"job-{i}", trace=gens[i % 3](world, i),
                                     weight=(2.0, 1.0, 1.5)[i % 3],
                                     port_share=None if sharing == "time-slice" else 1.0 / K)
                        for i in range(K))
        sp = w.plan_shared(w.SharedFabricRequest(tenants=tenants, n=48, cost_model=cm,
                                                 sharing=sharing))
        return sp.to_dict(), [(t.name, t.isolation, t.isolation_bound) for t in sp.tenants]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # the bench's bare strings
        got, want = _both(shared)
    assert got == want
    if sharing == "port-partition":
        assert all(iso == 1.0 for _, iso, _ in got[1])


@pytest.mark.parametrize("kind", FAULT_KINDS)
@pytest.mark.parametrize("fail_frac", [0.25, 0.75])
def test_run_with_recovery_equals_the_reference(kind, fail_frac):
    """faults_bench's recovery cycle (its recovery_for, verified) at n = 12."""
    def recover(pk):
        w, cm, sim, spec, timeline = pk[0], pk[1].replace(delta=1e-3), pk[2], pk[3], pk[4]
        trace = w.mixed_trace(12, moe_layers=1, train_steps=1, decode_steps=3)
        plan = w.plan_trace(trace, cm, mode="carryover")
        clean = sim(mode="sparse", chunks_per_msg=8).run_trace(plan.fabric_phases(), cm)
        faults = timeline(n=12, faults=(spec(
            kind=kind, time=fail_frac * clean.completion, node=12 if kind == "node-join" else 4,
            repair_s=0.05 * clean.completion if kind == "link-flap" else 0.0),),
            policy="requeue" if kind == "link-flap" else "drop")
        rr = w.run_with_recovery(trace, cm, faults=faults, chunks_per_msg=8, verify=True)
        return (dataclasses.asdict(rr.degraded), [e.to_dict() for e in rr.committed_events],
                rr.recovery_plan.to_dict(), rr.clean_plan.to_dict(),
                rr.restart_plan.to_dict(), rr.recovery_total, rr.restart_total,
                rr.recovery_ratio, rr.bit_identical, dataclasses.astuple(rr.stats))

    got, want = _both(recover)
    assert got == want
    assert got[7] <= 1 + 1e-9 and got[8]


def test_chip_smoke_rederives_the_committed_bench_rows():
    """chip_smoke.py's phase 11 workload check, run here on the CPU: one grid
    point of each bench re-derived by the port equals the committed row at
    1e-12 relative, and the bench's gates hold there."""
    out = chip_smoke.workload_rows()
    assert out["hot_plans_per_sec"] > 0

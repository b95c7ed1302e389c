"""Port parity: the static verifier and its mutation harness
(`repro_torch/analysis/verifier.py`, `mutations.py`) vs the reference.

Both are whole copies (held to the reference's text in
tests/test_torch_fabric.py).  Here the same artifacts go through both
packages in one process: the mutation harness's known-good fixtures verify
clean in both, and every corruption gives the same `Violation`s (rule,
location, message, severity, repro) in both, mutation by mutation, the
workload cases (trace plans, served plans, window choices, shared plans,
fault timelines, degraded states, recoveries, snapshots) included.  The
verifier memoizes per schedule and tape, so each case clears both
packages' caches first.
"""
import dataclasses
import warnings

import pytest

pytest.importorskip("torch")

from repro import analysis as ref_analysis  # noqa: E402
from repro.analysis import mutations as ref_mutations  # noqa: E402
from repro.core import PAPER_DEFAULT as REF_CM  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import mutations  # noqa: E402
from repro_torch.core import PAPER_DEFAULT  # noqa: E402

NAMES = [m.name for m in ref_mutations.mutations()]


@pytest.fixture(autouse=True)
def _cold_caches():
    analysis.clear_verifier_caches()
    ref_analysis.clear_verifier_caches()
    with warnings.catch_warnings():
        # the harness passes bare fabric strings, as the reference's does
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _found(violations) -> list[tuple]:
    return [dataclasses.astuple(v) for v in violations]


def test_analysis_exports_the_references():
    assert analysis.__all__ == ref_analysis.__all__
    assert all(hasattr(analysis, name) for name in analysis.__all__)


def test_run_mutations_equals_the_reference():
    got, want = mutations.run_mutations(), ref_mutations.run_mutations()
    assert [dataclasses.astuple(o) for o in got] == [dataclasses.astuple(o) for o in want]
    assert len(got) == len(NAMES) and all(o.caught for o in got)


@pytest.mark.parametrize("name", NAMES)
def test_each_mutation_gives_the_references_violations(name):
    got = {m.name: m for m in mutations.mutations()}[name]
    want = {m.name: m for m in ref_mutations.mutations()}[name]
    assert got.rule == want.rule
    found = _found(got.build())
    assert found == _found(want.build())
    assert got.rule in {v[0] for v in found}


# each verifier on the harness's known-good fixtures: (name, call(module, cm))
GOOD = {
    "verify_schedule": lambda m, cm: m.verify_schedule(m._good_schedule()),
    "verify_tape": lambda m, cm: m.verify_tape(m._good_tape()),
    "verify_plan": lambda m, cm: m.verify_plan(m._good_plan()),
    "verify_plan capped": lambda m, cm: m.verify_plan(m._good_capped_plan()),
    "verify_trace_plan": lambda m, cm: m.verify_trace_plan(m._good_trace_plan(), cm=cm),
    "verify_served_plan": lambda m, cm: m.verify_served_plan(m._good_served_plan(), cm),
    "verify_window_choice": lambda m, cm: m.verify_window_choice(16, m._good_window_choice()),
    "verify_shared_plan time-slice": lambda m, cm: m.verify_shared_plan(m._good_shared_plan()),
    "verify_shared_plan port-partition":
        lambda m, cm: m.verify_shared_plan(m._good_partition_plan()),
    "verify_snapshot": lambda m, cm: m.verify_snapshot(m._good_snapshot()),
    "verify_timeline": lambda m, cm: m.verify_timeline(m._good_timeline()),
    "verify_degraded": lambda m, cm: m.verify_degraded(
        m._good_recovery().degraded, phases=m._good_recovery().plan.fabric_phases(),
        chunks_per_msg=8),
    "verify_recovery": lambda m, cm: m.verify_recovery(
        m._good_recovery().degraded, m._good_recovery().recovery_plan,
        clean_plan=m._good_recovery().clean_plan),
}


@pytest.mark.parametrize("case", list(GOOD))
def test_good_fixtures_verify_clean_in_both(case):
    got = GOOD[case](mutations, PAPER_DEFAULT)
    want = GOOD[case](ref_mutations, REF_CM)
    assert _found(got) == _found(want) == []


def test_verified_plans_equal_the_references():
    """The port's verifying planner and the reference's give the same plans
    (to_dict) on the analytic and the event-scored fabric, the requests that
    carry fabric state and a reconfiguration budget included."""
    from repro.planner import Planner as RefPlanner
    from repro.planner import PlanRequest as RefPlanRequest
    from repro_torch.planner import Planner, PlanRequest

    planner, ref_planner = Planner(cache_size=0), RefPlanner(cache_size=0)
    assert planner.verify and ref_planner.verify
    for kind in ("a2a", "rs", "ag", "ar"):
        for n in (8, 12, 16):
            for fabric in ("ocs", "ocs-sim"):
                for extra in ({}, {"init_g": 2}, {"max_R": 1}):
                    if fabric == "ocs-sim" and (kind == "ar" or extra):
                        continue
                    kw = dict(kind=kind, n=n, m_bytes=2**22, fabric=fabric, **extra)
                    got = planner.plan(PlanRequest(**kw)).to_dict()
                    assert got == ref_planner.plan(RefPlanRequest(**kw)).to_dict(), kw

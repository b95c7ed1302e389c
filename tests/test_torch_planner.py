"""Port parity: the NumPy copies of `repro.core` and `repro.planner`, and the
gradient-sync planner glue, vs the reference.

The copies are held to the reference's text (only their imports point at
`repro_torch`), and the port's `gradient_sync_plan` and `plan("rs"/"ag")` to
the reference's answers on a grid of world sizes, payloads, fabrics and cost
models: the same implementation, the same schedules, and the same predicted
times and alternatives, exactly (the same float operations in the same order).
Both packages' default planners verify their plans.
"""
import dataclasses
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.collectives import gradient_sync_plan as jax_gradient_sync_plan  # noqa: E402
from repro.core import cost_model as ref_cost_model  # noqa: E402
from repro.core import schedules as ref_schedules  # noqa: E402
from repro.core.jsonio import FabricKind as RefFabricKind  # noqa: E402
from repro.planner import PlanRequest as RefPlanRequest  # noqa: E402
from repro.planner import default_planner as ref_default_planner  # noqa: E402
from repro_torch.analysis import VerificationError, verify_plan  # noqa: E402
from repro_torch.collectives import gradient_sync_plan  # noqa: E402
from repro_torch.core import schedules  # noqa: E402
from repro_torch.core.cost_model import PAPER_DEFAULT, CostModel  # noqa: E402
from repro_torch.core.jsonio import FabricKind  # noqa: E402
from repro_torch.planner import Planner, PlanRequest, default_planner  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = ["core/bruck.py", "core/schedules.py", "core/simulator.py", "core/subrings.py",
          "core/baselines.py", "core/jsonio.py", "planner/api.py", "planner/registry.py",
          "planner/strategies.py"]
TPU_V5E_FIELDS = {f: getattr(ref_cost_model.TPU_V5E, f)
                  for f in ("alpha_s", "alpha_h", "bandwidth", "delta")}
COST_MODELS = {"paper": PAPER_DEFAULT, "tpu_v5e_fields": CostModel(**TPU_V5E_FIELDS)}
NS = [2, 3, 4, 6, 8, 16, 96]
M_BYTES = [1e3, 1e6, 1e9]


@pytest.mark.parametrize("path", COPIES)
def test_copied_modules_equal_reference(path):
    port = (SRC / "repro_torch" / path).read_text().replace("repro_torch.", "repro.")
    assert port == (SRC / "repro" / path).read_text()


def test_cost_model_copy_drops_only_the_tpu_preset():
    port = (SRC / "repro_torch/core/cost_model.py").read_text()
    ref = (SRC / "repro/core/cost_model.py").read_text()
    cut = lambda s, start: s[:s.index(start)] + s[s.index("\n\n\n", s.index(start)):]  # noqa: E731
    assert cut(port, "#: One NVIDIA H100") == cut(ref, "#: TPU v5e")
    assert "TPU" not in port


def _same_schedule(got, want):
    if want is None:
        assert got is None
        return
    assert (got.kind, got.n, got.r, got.x) == (want.kind, want.n, want.r, want.x)
    assert got.link_offsets() == want.link_offsets()
    assert got.segment_lengths == want.segment_lengths


@pytest.mark.parametrize("cm", list(COST_MODELS))
@pytest.mark.parametrize("fabric", ["static", "ocs"])
@pytest.mark.parametrize("n", NS)
def test_gradient_sync_plan_equals_reference(n, fabric, cm):
    port_cm = COST_MODELS[cm]
    ref_cm = ref_cost_model.CostModel(**{f: getattr(port_cm, f) for f in TPU_V5E_FIELDS})
    for m in M_BYTES:
        got = gradient_sync_plan(n, m, port_cm, fabric=FabricKind(fabric))
        want = jax_gradient_sync_plan(n, m, ref_cm, fabric=RefFabricKind(fabric))
        assert got.impl == want.impl, (n, m)
        _same_schedule(got.rs_schedule, want.rs_schedule)
        _same_schedule(got.ag_schedule, want.ag_schedule)
        assert got.predicted_time == want.predicted_time, (n, m)
        assert got.alternatives == want.alternatives, (n, m)
        for kind in ("rs", "ag"):
            g = default_planner().plan(PlanRequest(kind=kind, n=n, m_bytes=m,
                                                   cost_model=port_cm,
                                                   fabric=FabricKind(fabric)))
            w = ref_default_planner().plan(RefPlanRequest(kind=kind, n=n, m_bytes=m,
                                                          cost_model=ref_cm,
                                                          fabric=RefFabricKind(fabric)))
            _same_schedule(g.schedule, w.schedule)
            assert (g.strategy, g.predicted_time) == (w.strategy, w.predicted_time)
            assert [(a.strategy, a.predicted_time, a.R, a.x) for a in g.alternatives] == \
                [(a.strategy, a.predicted_time, a.R, a.x) for a in w.alternatives]


def test_deprecated_plan_shim_uses_the_port_planner():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = schedules.plan("rs", 12, 1e6, PAPER_DEFAULT)
        want = ref_schedules.plan("rs", 12, 1e6, ref_cost_model.PAPER_DEFAULT)
    _same_schedule(got.schedule, want.schedule)
    assert got.predicted_time == want.predicted_time


def _corrupt(res):
    return dataclasses.replace(res, schedule=schedules.static_schedule("rs", res.request.n))


def _rejects_a_corrupt_plan(monkeypatch, cache_size):
    planner = Planner(cache_size=cache_size)
    req = PlanRequest(kind="a2a", n=8, m_bytes=2**20)
    good = planner._plan_uncached(req)
    monkeypatch.setattr(Planner, "_plan_uncached", lambda self, r: _corrupt(good))
    with pytest.raises(VerificationError, match="plan/kind"):
        planner.plan(req)
    assert len(planner._cache) == 0
    assert Planner(cache_size=cache_size, verify=False).plan(req).schedule.kind == "rs"
    monkeypatch.undo()
    res = planner.plan(req)
    assert not verify_plan(res)
    assert len(planner._cache) == min(cache_size, 1)


def test_unported_planner_paths_raise(monkeypatch):
    """`Planner()` verifies, as the reference's does (its tests/test_verifier.py
    trust-boundary case): a corrupted result raises VerificationError and is
    never cached; `verify=False` serves it unchecked; `default_planner()`
    verifies."""
    assert Planner().verify and default_planner().verify
    assert not Planner(verify=False).verify
    _rejects_a_corrupt_plan(monkeypatch, cache_size=8)
    assert gradient_sync_plan(1, 1e6, PAPER_DEFAULT).impl == "psum"


def test_uncached_planner_rejects_a_corrupt_plan(monkeypatch):
    _rejects_a_corrupt_plan(monkeypatch, cache_size=0)

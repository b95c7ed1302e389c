"""Unified planning API for BRIDGE collectives (paper Sections 3.3-3.6).

A copy of `repro.planner` for the port.  ``Planner()`` verifies every plan
before it is cached, as the reference's does; ``ocs-sim`` scoring plays its
candidates on the card (kernel B6) where one is present.

One entry point for all four collectives — All-to-All, Reduce-Scatter,
AllGather, and the composite AllReduce (``ar`` = RS + AG):

    from repro_torch.planner import FabricKind, Planner, PlanRequest

    res = Planner().plan(PlanRequest(kind="rs", n=96, m_bytes=16 * 2**20, r=3))
    res.schedule, res.predicted_time, res.breakdown, res.alternatives
    cached = PlanResult.from_json(res.to_json())   # lossless round trip

Event-scored planning and the cached serving path:

    planner = default_planner()                    # process-wide, LRU-cached
    res = planner.plan(PlanRequest(kind="a2a", n=96, m_bytes=2**24,
                                   fabric=FabricKind.OCS_SIM))  # event scores
    results = planner.plan_batch(requests)         # dedupes repeated traffic
    planner.cache_info()                           # hits / misses / size

Strategy families are pluggable via the registry (`register_strategy`);
importing this package registers the built-ins (periodic, rs-early, ag-late,
exact-dp, overlap, static, every-step, ring).  The legacy `repro.core.plan`
and `repro.collectives.plan_gradient_sync` entry points are thin shims over
this package.
"""
from . import strategies  # noqa: F401  (registers the built-in families)
from .api import (Candidate, FabricKind, PlanRequest,  # noqa: F401
                  PlanResult, RankedAlternative, SharingMode)
from .planner import PlanCacheInfo, Planner, default_planner  # noqa: F401
from .registry import (StrategyInfo, available_strategies,  # noqa: F401
                       default_strategy_names, get_strategy,
                       register_strategy, select_strategies,
                       unregister_strategy)

__all__ = [
    "Candidate", "FabricKind", "PlanRequest", "PlanResult",
    "RankedAlternative", "SharingMode",
    "PlanCacheInfo", "Planner", "default_planner",
    "StrategyInfo", "available_strategies", "default_strategy_names",
    "get_strategy", "register_strategy", "select_strategies",
    "unregister_strategy",
    "strategies",
]

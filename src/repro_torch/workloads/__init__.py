"""Workload traces: back-to-back collectives on one reconfigurable fabric.

Real training and serving workloads do not issue one collective on a cold
fabric — MoE All-to-All, gradient AllReduce, and decode AllGather arrive
back-to-back, and the circuits left behind by one collective are the
starting topology of the next.  This package raises BRIDGE's step-level
reuse argument one level:

  - `traces`        — typed `CollectiveEvent` / `Trace` records plus
                      deterministic generators that synthesize realistic
                      streams from the model-zoo configs (MoE a2a per layer,
                      per-step gradient AR, decode AG bursts), with JSON
                      round-tripping;
  - `trace_planner` — `plan_trace` extends the exact-R DP across collective
                      boundaries: the fabric's final link offsets of
                      collective i become the initial configuration of
                      collective i+1, boundaries pay delta only on circuits
                      that actually change (`core.schedules.changed_links`),
                      and per-collective R is chosen jointly under a
                      trace-wide delta budget.

  - `online_planner` — `OnlinePlanner` plans the same stream *online*: a
                      receding-horizon window of W upcoming events, the
                      joint DP warm-started at the committed fabric state,
                      commit-one-advance, and re-plan on mispredictions
                      (W = stream length recovers `plan_trace` exactly);
  - `serve`         — `PlanService` answers windowed plan requests through
                      a serving LRU (carryover state in the key) with
                      `request_storm` measuring plans/sec and hit rate;
  - `tenancy`       — multi-tenant fabric sharing: `plan_shared` allocates
                      one fabric across K tenants by disjoint port
                      partitions or whole-collective time slices, with
                      per-tenant SLA weights, delta budgets, and measured
                      isolation bounds;
  - `recovery`      — the failure → snapshot → re-plan → verify loop:
                      `run_with_recovery` maps a `core.faults.DegradedState`
                      back to whole events, re-plans the remainder at the
                      surviving world size (bit-identical to the offline
                      plan of the reduced trace), and measures resume-from-
                      snapshot vs restart-from-scratch.

Fabric execution of a planned trace lives in `core.fabricsim.FabricSim
.run_trace` / `core.batchsim.batch_run_trace` (now with mid-trace
snapshot/restore via `core.FabricSnapshot`); benchmarks/trace_bench.py
records carryover vs cold-fabric vs static on mixed traces and
benchmarks/online_bench.py the online-vs-offline regret and serving
throughput.
"""
from .online_planner import OnlinePlanner, OnlineStats, run_online
from .recovery import (RecoveryResult, reduced_trace, replan_after_fault,
                       run_with_recovery, split_events)
from .serve import (PlanService, ServeCacheInfo, ServeRequest, ServedPlan,
                    StormResult, build_request_pool, request_storm)
from .tenancy import (SharedFabricRequest, SharedPhase, SharedPlan,
                      TenantPlan, TenantSpec, candidate_orders, plan_shared,
                      score_shared_plans, shared_window_dp)
from .trace_planner import (PhaseCandidate, PhasePlan, TRACE_PLAN_MODES,
                            TracePlan, phase_candidates, plan_trace,
                            window_dp)
from .traces import (CollectiveEvent, Trace, approx_param_bytes,
                     concat_traces, decode_ag_trace, mixed_trace,
                     moe_a2a_trace, train_step_trace)

__all__ = [
    "CollectiveEvent", "Trace", "approx_param_bytes", "concat_traces",
    "decode_ag_trace", "mixed_trace", "moe_a2a_trace", "train_step_trace",
    "PhaseCandidate", "PhasePlan", "TRACE_PLAN_MODES", "TracePlan",
    "phase_candidates", "plan_trace", "window_dp",
    "OnlinePlanner", "OnlineStats", "run_online",
    "RecoveryResult", "reduced_trace", "replan_after_fault",
    "run_with_recovery", "split_events",
    "PlanService", "ServeCacheInfo", "ServeRequest", "ServedPlan",
    "StormResult", "build_request_pool", "request_storm",
    "SharedFabricRequest", "SharedPhase", "SharedPlan", "TenantPlan",
    "TenantSpec", "candidate_orders", "plan_shared", "score_shared_plans",
    "shared_window_dp",
]

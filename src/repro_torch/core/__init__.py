"""BRIDGE core of the port: reconfiguration-schedule synthesis (NumPy) and
the fabric simulators.

Copies of the `repro.core` modules, as they are: only their imports point at
`repro_torch`.  The cost model drops the reference's TPU preset and adds
`H100_NVLINK`.  `batchsim` names the port's playback engines ("numpy",
"torch", "auto"; `batchsim_torch` plays certified lanes on the card with the
CUDA kernel B6); `fabricsim`'s checkpointed traces and `faults`'
`latest_snapshot` write and read through the port's `checkpoint.store`.
"""
from . import baselines
from .batchsim import (BatchFabricResult, BatchLane, BatchTraceResult,
                       FabricSnapshot, ScheduleTape, TraceLane,
                       batch_completion_times, batch_run, batch_run_trace,
                       clear_tape_caches, compile_tape)
from .bruck import (Collective, Step, a2a_steps, ag_steps, is_pow2, num_steps,
                    rs_steps, schedule_length, simulate_a2a_data,
                    simulate_ag_data, simulate_rs_data, step_counts, steps_for)
from .cost_model import (H100_NVLINK, OCS_TECHNOLOGIES, PAPER_DEFAULT, CostModel,
                         gbps, ocs_ports, ocs_preset)
from .fabricsim import (FabricResult, FabricSim, TraceFabricResult,
                        simulate_fabric, simulate_trace, straggler_speeds,
                        trace_boundary_changed)
from .faults import (ABRUPT_KINDS, DELIVERY_POLICIES, FAULT_KINDS,
                     DegradedState, FaultSpec, FaultTimeline, latest_snapshot,
                     random_timeline, snapshot_to_tree, tree_to_snapshot,
                     world_after)
from .schedules import (Plan, Schedule, SegmentTables, ag_transmission_optimal,
                        ag_transmission_optimal_all, candidate_schedules,
                        changed_links, clear_schedule_caches, cstar_a2a,
                        dp_stats, every_step_schedule, full_cost_optimal,
                        full_cost_optimal_all, periodic, periodic_a2a,
                        periodic_a2a_all, periodic_all, plan, reset_dp_stats,
                        rs_transmission_optimal, rs_transmission_optimal_all,
                        static_schedule)
from .simulator import (StepCost, TimeBreakdown, allreduce_time,
                        allreduce_time_overlap, collective_time,
                        collective_time_overlap)
from .subrings import BlockedRing, Topology, ring, subring_topology

__all__ = [
    "Collective", "Step", "a2a_steps", "ag_steps", "is_pow2", "num_steps",
    "rs_steps", "schedule_length", "simulate_a2a_data", "simulate_ag_data",
    "simulate_rs_data", "step_counts", "steps_for",
    "BatchFabricResult", "BatchLane", "BatchTraceResult", "FabricSnapshot",
    "ScheduleTape", "TraceLane", "batch_completion_times", "batch_run",
    "batch_run_trace", "clear_tape_caches", "compile_tape",
    "H100_NVLINK", "OCS_TECHNOLOGIES", "PAPER_DEFAULT", "CostModel", "gbps",
    "ocs_ports", "ocs_preset",
    "Plan", "Schedule", "SegmentTables", "ag_transmission_optimal",
    "ag_transmission_optimal_all", "candidate_schedules", "changed_links",
    "clear_schedule_caches", "cstar_a2a", "dp_stats", "every_step_schedule",
    "full_cost_optimal", "full_cost_optimal_all", "periodic", "periodic_a2a",
    "periodic_a2a_all", "periodic_all", "plan", "reset_dp_stats",
    "rs_transmission_optimal", "rs_transmission_optimal_all",
    "static_schedule",
    "FabricResult", "FabricSim", "TraceFabricResult", "simulate_fabric",
    "simulate_trace", "trace_boundary_changed", "straggler_speeds",
    "ABRUPT_KINDS", "DELIVERY_POLICIES", "FAULT_KINDS", "DegradedState",
    "FaultSpec", "FaultTimeline", "latest_snapshot", "random_timeline",
    "snapshot_to_tree", "tree_to_snapshot", "world_after",
    "StepCost", "TimeBreakdown", "allreduce_time", "allreduce_time_overlap",
    "collective_time", "collective_time_overlap",
    "BlockedRing", "Topology", "ring", "subring_topology", "baselines",
]

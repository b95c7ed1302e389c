"""BRIDGE core of the port: reconfiguration-schedule synthesis (NumPy).

Copies of the `repro.core` modules that the planner and the collectives need
(`bruck`, `cost_model`, `schedules`, `simulator`, `subrings`, `baselines`,
`jsonio`), as they are: only their imports point at `repro_torch`.  The cost
model drops the reference's TPU preset and adds `H100_NVLINK`.  The fabric
simulators (`batchsim`, `fabricsim`, `faults`) come with ROADMAP A8.
"""
from . import baselines
from .bruck import (Collective, Step, a2a_steps, ag_steps, is_pow2, num_steps,
                    rs_steps, schedule_length, step_counts, steps_for)
from .cost_model import (H100_NVLINK, OCS_TECHNOLOGIES, PAPER_DEFAULT, CostModel,
                         gbps, ocs_ports, ocs_preset)
from .schedules import Schedule, every_step_schedule, static_schedule
from .simulator import (StepCost, TimeBreakdown, allreduce_time,
                        collective_time)

__all__ = [
    "Collective", "Step", "a2a_steps", "ag_steps", "is_pow2", "num_steps",
    "rs_steps", "schedule_length", "step_counts", "steps_for",
    "H100_NVLINK", "OCS_TECHNOLOGIES", "PAPER_DEFAULT", "CostModel", "gbps",
    "ocs_ports", "ocs_preset",
    "Schedule", "every_step_schedule", "static_schedule",
    "StepCost", "TimeBreakdown", "allreduce_time", "collective_time",
    "baselines",
]

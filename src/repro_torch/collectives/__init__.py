"""BRIDGE collectives of the port: Bruck-pattern log-step collectives over
`torch.distributed` point-to-point (NCCL on the card, gloo on the CPU).

The port of `repro.collectives` for gradient sync: Bruck reduce-scatter and
all-gather, ring baselines, the Bruck and Bridge all-reduce, and the planner
glue `gradient_sync_plan`.  The compressed all-reduce comes with ROADMAP A3,
the Bruck all-to-all with A4.
"""
from .allreduce import (bridge_all_reduce, bruck_all_reduce, ring_all_gather,
                        ring_all_reduce, ring_reduce_scatter)
from .bruck_rs_ag import bruck_all_gather, bruck_reduce_scatter, shift
from .schedule_bridge import CollectivePlan, gradient_sync_plan

__all__ = [
    "bridge_all_reduce", "bruck_all_gather", "bruck_all_reduce",
    "bruck_reduce_scatter", "ring_all_gather", "ring_all_reduce",
    "ring_reduce_scatter", "shift", "CollectivePlan", "gradient_sync_plan",
]

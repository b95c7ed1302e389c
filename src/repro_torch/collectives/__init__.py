"""BRIDGE collectives of the port: Bruck-pattern log-step collectives over
`torch.distributed` point-to-point (NCCL on the card, gloo on the CPU).

The port of `repro.collectives`: Bruck reduce-scatter, all-gather and
all-to-all, ring baselines, the Bruck and Bridge all-reduce, the int8
compressed all-reduce with error feedback, and the planner glue
`gradient_sync_plan`.
"""
from .allreduce import (bridge_all_reduce, bruck_all_reduce, ring_all_gather,
                        ring_all_reduce, ring_reduce_scatter)
from .bruck_a2a import bruck_all_to_all
from .bruck_rs_ag import bruck_all_gather, bruck_reduce_scatter, shift
from .compression import compressed_all_reduce, make_error_feedback_state
from .schedule_bridge import CollectivePlan, gradient_sync_plan

__all__ = [
    "bridge_all_reduce", "bruck_all_gather", "bruck_all_reduce", "bruck_all_to_all",
    "bruck_reduce_scatter", "compressed_all_reduce", "make_error_feedback_state",
    "ring_all_gather", "ring_all_reduce", "ring_reduce_scatter", "shift",
    "CollectivePlan", "gradient_sync_plan",
]

"""mfu.train: the training step's model FLOPs (the reference's
`step_flops`: 6 N a token and causal attention, remat's recompute not
counted) over the step time on the host clock in the window's unprofiled
steps, as a share of the cards' bf16 peak (989 TFLOP/s each)."""
import importlib

from harness.roofline import BF16_FLOP_S


def read(run):
    if run["platform"] != "gpu":
        return None
    t, w = run["traffic"], run["window"]
    ref = importlib.import_module(f"reference.{run['reference']}")
    flops = ref.step_flops(run["config"], t["batch_per_rank"] * t["ranks"], t["seq"])
    return 100 * flops / (w["seconds"] / w["steps"]) / (BF16_FLOP_S * run["chips"])

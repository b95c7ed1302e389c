"""mfu.serve: the forward FLOPs of every prompt token and every decoded
token the window's batches ran (the reference's `token_flops`, 2 N a token
and the recurrence's readout), over the window, as a share of the card's
bf16 peak (989 TFLOP/s)."""
import importlib

from harness.roofline import BF16_FLOP_S


def read(run):
    if run["platform"] != "gpu":
        return None
    w = run["window"]
    ref = importlib.import_module(f"reference.{run['reference']}")
    flops = ref.token_flops(run["config"]) * w["tokens_per_batch"] * w["batches"]
    return 100 * flops / w["seconds"] / (BF16_FLOP_S * run["chips"])

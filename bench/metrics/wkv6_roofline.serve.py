"""wkv6_roofline.serve: the least time of every B5 call the traced batches
ran (the frozen `bound`: a prefill call at (requests, heads, prompt, hd,
hd) from the caches' state, its two passes `wkv6_state_kernel` and
`wkv6_output_kernel`; a decode call `wkv6_step_kernel` at T = 1), summed,
over the summed device time of those kernels."""
from harness import roofline as rl

PASSES = ("wkv6_state_kernel", "wkv6_output_kernel", "wkv6_step_kernel")


def read(run):
    tr = run.get("trace")
    if run["platform"] != "gpu" or not tr:
        return None
    a, t = run["config"], run["traffic"]
    hd = a["rwkv_head_dim"]
    h, b = a["d_model"] // hd, t["requests"]
    prefill = rl.bound(*rl.wkv_work(b, h, t["prompt"], hd, hd, True))[0]
    step = rl.bound(*rl.wkv_work(b, h, 1, hd, hd, True))[0]
    calls = {k.split("::")[-1]: v for k, v in tr["kernels"].items()}
    spent = sum(calls[k][1] for k in PASSES if k in calls)
    bound = (calls.get("wkv6_state_kernel", [0])[0] * prefill
             + calls.get("wkv6_step_kernel", [0])[0] * step) / 1e3
    return 100 * bound / spent if spent else None

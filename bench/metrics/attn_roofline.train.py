"""attn_roofline.train: the least time of every B1, B2 and B3 launch the
traced steps ran (the frozen `bound` at the step's shapes: a rank's rows,
every head, the sequence, causal), summed, over the summed device time of
those launches."""
from harness import roofline as rl

TC = {"flash_fwd_tc_kernel": rl.flash_fwd_work, "flash_bwd_dkv_tc_kernel": rl.flash_bwd_dkv_work,
      "flash_bwd_dq_tc_kernel": rl.flash_bwd_dq_work}


def read(run):
    tr = run.get("trace")
    if run["platform"] != "gpu" or not tr:
        return None
    a, t = run["config"], run["traffic"]
    b, h, hkv, s = t["batch_per_rank"], a["num_heads"], a["num_kv_heads"], t["seq"]
    d = a["d_model"] // h
    least = {"flash_fwd_tc_kernel": rl.flash_fwd_work(b, h, hkv, s, s, d, True),
             "flash_bwd_dkv_tc_kernel": rl.flash_bwd_dkv_work(b, h, s, s, d, True),
             "flash_bwd_dq_tc_kernel": rl.flash_bwd_dq_work(b, h, s, s, d, True)}
    ms = {k: rl.bound(*work)[0] for k, work in least.items()}
    spent = bound = 0.0
    for name, (n, secs) in tr["kernels"].items():
        key = name.split("::")[-1]
        if key in ms:
            bound += n * ms[key] / 1e3
            spent += secs
    return 100 * bound / spent if spent else None

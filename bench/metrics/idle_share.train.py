"""idle_share.train: the share of the traced steps' stretch in which no
operation ran on rank 0's card."""


def read(run):
    tr = run.get("trace")
    if run["platform"] != "gpu" or not tr:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])

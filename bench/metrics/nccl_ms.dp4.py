"""nccl_ms.dp4: the summed device time of the NCCL kernels a traced step
ran on rank 0 (the gradient sync's sends and receives, and the step's small
all-reduces of the loss and metrics), waiting on peers included."""


def read(run):
    tr = run.get("trace")
    if run["platform"] != "gpu" or not tr:
        return None
    secs = sum(v[1] for k, v in tr["kernels"].items() if "nccl" in k.lower())
    return 1e3 * secs / run["profiled_steps"] if secs else None

"""replay_gap_share.serve: the device seconds between consecutive replays
(the ids' read, the host loop, the next launch) over the decode stretches
(each batch's first replay's start to its last one's end), summed over the
window's batches, from the `decode spans:` lines that `decode_loop` prints;
timed by CUDA events with no profiler running.  None where no line has them."""
import re

LINE = re.compile(r"between replays ([0-9.]+) s device, stretch ([0-9.]+) s device")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [m for m in got if m]
    stretch = sum(float(m.group(2)) for m in got)
    return 100 * sum(float(m.group(1)) for m in got) / stretch if stretch else None

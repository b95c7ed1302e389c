"""capture_ms.serve: the decode step's warm-up plus its capture as a CUDA
graph, which every batch builds anew, in ms: the mean over the window's
batches of the host seconds that the `decode spans:` lines of `decode_loop`
give them.  None where no line has them."""
import re

LINE = re.compile(r"decode spans: .*; warm-up ([0-9.]+) s, capture ([0-9.]+) s")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [float(m.group(1)) + float(m.group(2)) for m in got if m]
    return 1e3 * sum(got) / len(got) if got else None

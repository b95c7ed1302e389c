"""decode_tokens_per_s.serve: every decoded token of the window's batches
over the decode seconds that `decode_loop` prints for each (its host clock
from the prefill's ids to the last step's, the graph's warm-up and capture
included)."""
import re

LINE = re.compile(r"decode: (\d+) tokens in \d+ steps, ([0-9.]+)s")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [m for m in got if m]
    secs = sum(float(m.group(2)) for m in got)
    return sum(int(m.group(1)) for m in got) / secs if secs else None

"""prefill_tokens_per_s.serve: every prompt token of the window's batches
over the prefill seconds that `serve_requests` prints for each (its host
clock, ending in the host's read of the first ids)."""
import re

LINE = re.compile(r"prefill: (\d+) x (\d+) tokens in ([0-9.]+)s")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [m for m in got if m]
    secs = sum(float(m.group(3)) for m in got)
    return sum(int(m.group(1)) * int(m.group(2)) for m in got) / secs if secs else None

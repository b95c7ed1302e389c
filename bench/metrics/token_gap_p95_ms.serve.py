"""token_gap_p95_ms.serve: the median over the window's batches of each
batch's 95th percentile of the host-clock gaps between consecutive reads of
the ids (255 gaps a batch of 256 tokens, the first holding the warm-up step
and the capture), from the `decode spans:` lines that `decode_loop` prints.
None where no line has them."""
import re
import statistics

LINE = re.compile(r"decode spans: .*token gap ms p50 [0-9.]+ p95 ([0-9.]+) ")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [float(m.group(1)) for m in got if m]
    return statistics.median(got) if got else None

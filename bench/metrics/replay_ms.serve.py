"""replay_ms.serve: the device seconds of every replay of the window's
batches over their number, in ms, from the `decode spans:` line that
`decode_loop` prints for each (a replay runs from a CUDA event just before
`graph.replay()` to one just after: the graph's kernels, the gaps inside it
and the launch's latency on the device).  None where no line has them (off
the card, or a program that prints no such line)."""
import re

LINE = re.compile(r"decode spans: (\d+) replays, .*; replays ([0-9.]+) s device,")


def read(run):
    if run["platform"] != "gpu":
        return None
    got = [LINE.search(x) for x in run.get("lines", [])]
    got = [m for m in got if m]
    replays = sum(int(m.group(1)) for m in got)
    return 1e3 * sum(float(m.group(2)) for m in got) / replays if replays else None

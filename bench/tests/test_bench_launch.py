"""The launcher of a cell on several cards (`harness.launch.spawn`), on the
CPU with stand-in ranks: rank 0's output comes back, a failed rank or the
deadline stops the others, and none is left running."""
from __future__ import annotations

import sys
import time

import pytest

from harness import launch

RANK = """
import os, sys, time
rank = int(sys.argv[sys.argv.index("--rank") + 1])
port = int(sys.argv[sys.argv.index("--port") + 1])
mode = sys.argv[1]
assert os.environ["RANK"] == str(rank) and os.environ["MASTER_PORT"] == str(port)
if mode == "ok":
    print("rank", rank, "of", os.environ["WORLD_SIZE"], flush=True)
elif mode == "fail" and rank == 1:
    sys.exit(5)
else:
    time.sleep(60)
"""


def test_rank_0s_lines_come_back_and_the_others_go_to_standard_error(capfd):
    code, lines = launch.spawn([sys.executable, "-c", RANK, "ok"], 3)
    assert code == 0 and lines == ["rank 0 of 3\n"]
    err = capfd.readouterr().err
    assert "rank 1 of 3" in err and "rank 2 of 3" in err


@pytest.mark.parametrize("mode,deadline,want", [("fail", float("inf"), 5), ("sleep", 2.0, 124)])
def test_a_failed_rank_or_the_deadline_stops_every_rank(mode, deadline, want):
    t = time.time()
    code, lines = launch.spawn([sys.executable, "-c", RANK, mode], 2, deadline=t + deadline)
    assert code == want and lines == []
    assert time.time() - t < 40

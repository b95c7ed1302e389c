"""On the card, at the cells' own sizes: the control (the reference with fp8
products in the program's place) comes out not correct under each cell's
limits where the program's run on the same seed comes out correct, and a
short run of each one-card cell through the command prints a correct line.

    PYTHONPATH=src python -m pytest -q -m cuda bench/tests/test_bench_card.py

(one H100; ~4 minutes, most of it the references).  Skips without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

import calibrate
from conftest import ROOT

from harness import runner, spec

ONE_CARD = [w["name"] for w in spec.load(ROOT)["workloads"] if w["chips"] == 1]


def _fails(row: dict, limits: dict) -> bool:
    return any(row[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    cell = spec.cell(spec.load(ROOT), name, ROOT)
    ctx = runner.Context(cell=cell, seed=2 ** 31 + 101, seconds=0.0, trace=False,
                         device=card, t0=time.time())
    rows = {r["what"]: r for r in calibrate.readings(ctx, control=True, faults=[])}
    assert not _fails(rows["program"], cell.limits), rows["program"]
    assert _fails(rows["control"], cell.limits), rows["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_short_run_through_the_command_is_correct(card, name):
    del card
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                           str(2 ** 31 + 202), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line

"""The readers of the serving driver's `decode spans:` lines
(`metrics/{replay_ms,replay_gap_share,token_gap_p95_ms,capture_ms}.serve.py`):
nothing off the card or where the program prints no such line, the values
worked out by hand on two batches' lines, and a tiny CPU serving run whose
lines the serving readers still read."""
from __future__ import annotations

import time

import pytest
import torch
from conftest import ROOT, tiny_cell

from harness import runner, spec

NAMES = ("replay_ms.serve", "replay_gap_share.serve", "token_gap_p95_ms.serve",
         "capture_ms.serve")

# two batches of 32 x (1024 + 256): 254 replays, 255 gaps between reads of the ids
LINES = [
    "prefill: 32 x 1024 tokens in 0.940s (34859.6 tok/s)",
    "decode: 8160 tokens in 255 steps, 3.010s (2710.9 tok/s), "
    "CUDA graph: warm-up and capture 0.300s, 254 replays",
    "decode spans: 254 replays, 1 captures, 1 eager; replays 2.540000 s device, "
    "between replays 0.160000 s device, stretch 2.700000 s device; token gap ms p50 10.600 "
    "p95 11.200 max 301.000 (host, 255 gaps); warm-up 0.060000 s, capture 0.240000 s",
    "prefill: 32 x 1024 tokens in 0.950s (34493.5 tok/s)",
    "decode: 8160 tokens in 255 steps, 3.100s (2632.3 tok/s), "
    "CUDA graph: warm-up and capture 0.400s, 254 replays",
    "decode spans: 254 replays, 1 captures, 1 eager; replays 2.794000 s device, "
    "between replays 0.140000 s device, stretch 2.934000 s device; token gap ms p50 11.000 "
    "p95 12.000 max 402.000 (host, 255 gaps); warm-up 0.070000 s, capture 0.330000 s",
]
BY_HAND = {
    "replay_ms.serve": 1e3 * (2.54 + 2.794) / 508,               # 10.5 ms
    "replay_gap_share.serve": 100 * (0.16 + 0.14) / (2.7 + 2.934),  # 5.32 %
    "token_gap_p95_ms.serve": (11.2 + 12.0) / 2,                 # the median of two
    "capture_ms.serve": 1e3 * ((0.06 + 0.24) + (0.07 + 0.33)) / 2,  # 350 ms
}


def _run(lines, platform="gpu"):
    return {"platform": platform, "lines": lines, "trace": None}


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_nothing_off_the_card(name):
    assert spec.reader(name, ROOT)(_run(LINES, "cpu")) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_pools_two_batches_as_worked_out_by_hand(name):
    assert spec.reader(name, ROOT)(_run(LINES)) == pytest.approx(BY_HAND[name])


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_nothing_where_no_decode_spans_line_was_printed(name):
    without = [x for x in LINES if not x.startswith("decode spans:")]
    assert spec.reader(name, ROOT)(_run(without)) is None
    assert spec.reader(name, ROOT)(_run([])) is None


def test_a_tiny_cpu_serving_run_still_feeds_the_serving_readers():
    from harness import serve
    cell = tiny_cell("rwkv6-3b.serve")
    ctx = runner.Context(cell=cell, seed=2 ** 31 + 23, seconds=0.3, trace=False,
                         device=torch.device("cpu"), t0=time.time())
    out = serve.run(ctx)
    lines = out["record"]["lines"]
    assert lines and len(lines) % 3 == 0
    assert all(x.startswith("decode spans:") for x in lines[2::3])
    record = dict(out["record"], platform="cpu")
    for m in cell.per_layer:
        if m["source"] == "program_span":
            assert spec.reader(m["name"], ROOT)(record) is None
    # read as the card's, the lines give the serving readers their numbers;
    # a CPU line has no device time and no capture
    as_card = dict(record, platform="gpu")
    for name in ("prefill_tokens_per_s.serve", "decode_tokens_per_s.serve",
                 "token_gap_p95_ms.serve"):
        assert spec.reader(name, ROOT)(as_card) > 0, name
    for name in ("replay_ms.serve", "replay_gap_share.serve", "capture_ms.serve"):
        assert spec.reader(name, ROOT)(as_card) is None, name

"""The port's spans and counters (`repro_torch.spans`, `collectives.shift`'s
counters, the drivers' lines) on the CPU: spans add no host event without a
profiler and nest under one as the drivers nest them; the serving driver's
`decode spans:` line and the training driver's step line keep the lines the
benchmark's readers read; on 2 gloo ranks, `shift.calls` and `shift.bytes`
count 2(n - 1) shifts a leaf and the chunks' bytes, ring and Bruck alike.
Imports no JAX."""
import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from _torch_dist_worker import spawn  # noqa: E402

from repro_torch import configs, spans  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["train.forward", "train.backward", "train.sync", "train.metrics",
          "train.optimizer"]


def _reader(name: str):
    """The `read` and `LINE` of the benchmark's reader file `name`."""
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _annotations(prof, prefix: str) -> list:
    return [e for e in prof.events() if e.name.startswith(prefix) and e.is_user_annotation]


def _model(arch: str):
    cfg = dataclasses.replace(configs.get(arch).scaled_down(), dtype="float32")
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_a_span_adds_no_host_event_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with spans.span("off"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("on"):
            torch.ones(2).add_(1)
    assert made == ["on"]
    assert [e.name for e in _annotations(prof, "on")] == ["on"]
    with spans.span("off again"):
        pass
    assert made == ["on"]


def test_marks_read_nothing_off_the_card():
    marks = spans.Marks()
    marks.reset()
    for _ in range(3):
        marks.mark(torch.device("cpu"))
    assert marks.intervals() is None and marks.elapsed() is None


def _train_step(arch="stablelm-3b"):
    tc = train.TrainConfig(arch=arch, batch_size=2, seq_len=16)
    model = _model(arch)
    step = train.make_train_step(tc, train.layout(tc, train.current_world(), None))
    gen = np.random.default_rng(0)
    tokens = torch.from_numpy(gen.integers(0, model.cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return step, model, batch


def test_train_spans_nest_in_the_step_under_the_profiler():
    step, model, batch = _train_step()
    opt = train.adamw_init(list(model.parameters()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            _, metrics, _ = step(model, opt, batch)
            float(metrics["loss"])
    outer = _annotations(prof, "outer")[0]
    got = sorted(_annotations(prof, "train."), key=lambda e: e.time_range.start)
    assert [e.name for e in got] == PHASES   # one rank: no leaf is synced
    for e in got:
        assert e.cpu_parent is not None and e.cpu_parent.name == "outer"
        assert outer.time_range.start <= e.time_range.start <= e.time_range.end \
            <= outer.time_range.end
    for a, b in zip(got, got[1:]):
        assert a.time_range.end <= b.time_range.start
    assert step.phase_seconds() is None and step.shifts == (0, 0)
    assert set(metrics) >= {"loss", "grad_norm", "lr"}


def test_the_step_gives_the_same_state_with_the_profiler_on_and_off():
    step, model, batch = _train_step()
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    _, plain, _ = step(model, train.adamw_init(params), batch)
    after = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, s in zip(params, start, strict=True):
            p.copy_(s)
    with profile(activities=[ProfilerActivity.CPU]):
        _, traced, _ = step(model, train.adamw_init(params), batch)
    assert {k: float(v) for k, v in plain.items()} == {k: float(v) for k, v in traced.items()}
    for p, a in zip(params, after, strict=True):
        assert torch.equal(p, a)


def test_the_train_line_keeps_its_dt_and_adds_the_phases_and_shifts():
    lines = []
    tc = train.TrainConfig(arch="stablelm-3b", steps=2, batch_size=2, seq_len=16)
    train.train(tc, lines.append, device="cpu")
    assert len(lines) == 2
    for line in lines:
        assert re.search(r"dt ([0-9.]+)s", line)
        assert line.endswith("s; device s not timed (cpu); 0 shifts, 0 bytes"), line


def _serve(arch="rwkv6-3b", new_tokens=6, prof=None):
    model = _model(arch)
    rng = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, model.cfg.vocab_size, 8)
                          .astype(np.int32), max_new_tokens=new_tokens) for i in range(2)]
    lines = []
    with prof if prof is not None else contextlib.nullcontext():
        out = serve.serve_requests(model.cfg, model, reqs, max_seq=8 + new_tokens + 1,
                                   progress=lines.append, device="cpu")
    # the captures and eager steps, as the `decode spans:` line counts them
    counted = tuple(int(n) for n in re.match(r"decode spans: \d+ replays, (\d+) captures, "
                                             r"(\d+) eager;", lines[-1]).groups())
    return out, lines, counted


def test_the_cpu_decode_prints_its_spans_line_and_keeps_the_readers_lines():
    out, lines, counted = _serve(new_tokens=6)
    assert all(len(t) == 6 for t in out.values())
    assert len(lines) == 3
    assert _reader("prefill_tokens_per_s.serve").LINE.search(lines[0])
    assert _reader("decode_tokens_per_s.serve").LINE.search(lines[1])
    assert lines[1].endswith(", eager")
    got = re.fullmatch(r"decode spans: 0 replays, 0 captures, 5 eager; device not timed "
                       r"\(cpu\); token gap ms p50 ([0-9.]+) p95 ([0-9.]+) max ([0-9.]+) "
                       r"\(host, 5 gaps\)", lines[2])
    assert got, lines[2]
    p50, p95, top = map(float, got.groups())
    assert 0 < p50 <= p95 <= top
    assert counted == (0, 5)
    # a run the card's readers would read, were it the card's: only the host's gaps
    run = {"platform": "gpu", "lines": lines}
    assert _reader("token_gap_p95_ms.serve").read(run) == pytest.approx(p95)
    for name in ("replay_ms.serve", "replay_gap_share.serve", "capture_ms.serve"):
        assert _reader(name).read(run) is None


def test_serve_spans_appear_under_the_profiler():
    prof = profile(activities=[ProfilerActivity.CPU])
    _, _, counted = _serve(new_tokens=4, prof=prof)
    got = sorted(_annotations(prof, "serve."), key=lambda e: e.time_range.start)
    assert [e.name for e in got] == ["serve.prefill"] + ["serve.decode.read"] * 4
    assert counted == (0, 3)


class _FakeMarks:
    """Marks of three replays: 10, 11 and 12 ms, 1 and 2 ms between them."""

    def intervals(self):
        return [0.010, 0.001, 0.011, 0.002, 0.012]

    def elapsed(self):
        return 0.036


def test_the_card_decode_line_pools_exactly_in_the_readers():
    captured = types.SimpleNamespace(replays=3, warmup_s=0.05, capture_s=0.25)
    reads = [0.0, 0.4, 0.41, 0.422, 0.435, 0.447]
    line = serve.decode_spans_line(captured, 1, _FakeMarks(), reads, torch.device("cuda", 0))
    assert line == ("decode spans: 3 replays, 1 captures, 1 eager; replays 0.033000 s device, "
                    "between replays 0.003000 s device, stretch 0.036000 s device; token gap ms "
                    "p50 12.000 p95 400.000 max 400.000 (host, 5 gaps); warm-up 0.050000 s, "
                    "capture 0.250000 s")
    run = {"platform": "gpu", "lines": [line, line.replace("p95 400.000", "p95 20.000")]}
    assert _reader("replay_ms.serve").read(run) == pytest.approx(11.0)
    assert _reader("replay_gap_share.serve").read(run) == pytest.approx(100 * 3 / 36)
    assert _reader("token_gap_p95_ms.serve").read(run) == pytest.approx(210.0)
    assert _reader("capture_ms.serve").read(run) == pytest.approx(300.0)
    eager = serve.decode_spans_line(None, 4, spans.Marks(), reads[:5], torch.device("cuda", 0))
    assert "device not timed (no replays)" in eager and "warm-up" not in eager


def test_nearest_rank_p95_of_255_gaps_leaves_12_beyond():
    reads = list(np.cumsum([0.0] + [0.001 * (i + 1) for i in range(255)]))
    line = serve.decode_spans_line(None, 255, spans.Marks(), reads, torch.device("cpu"))
    p95 = float(re.search(r"p95 ([0-9.]+)", line).group(1))
    assert sum(1e3 * (b - a) > p95 + 1e-6 for a, b in zip(reads, reads[1:])) == 12
    assert p95 == pytest.approx(243.0)
    assert float(re.search(r"max ([0-9.]+)", line).group(1)) == pytest.approx(255.0)


def test_shift_counts_the_sync_over_two_gloo_ranks(tmp_path):
    out = tmp_path / "spans.json"
    spawn("spans", 2, str(out), timeout=240)
    got = json.loads(out.read_text())
    n = 2

    def expected(sizes):
        """2(n - 1) shifts a leaf, each sending one of its n padded chunks."""
        return [2 * (n - 1) * len(sizes),
                sum(2 * (n - 1) * math.ceil(k / n) * b for k, b in sizes)]

    leaves = [(7 * 11, 4), (5, 2)]
    assert got["leaves"] == {"ring": expected(leaves), "bruck": expected(leaves)}
    assert got["shifts"] == expected(got["params"])
    assert got["phases"] is None
    assert all(s[3] for s in got["spans"])
    named = {}
    for name, start, end, _ in got["spans"]:
        named.setdefault(name, []).append((start, end))
    assert sorted(named) == sorted(["outer", "train.sync.leaf", *PHASES])
    assert all(len(named[p]) == 1 for p in PHASES)
    assert len(named["train.sync.leaf"]) == len(got["params"])
    (sync_start, sync_end), = named["train.sync"]
    assert all(sync_start <= s <= e <= sync_end for s, e in named["train.sync.leaf"])

"""Runs of tiny cells on the CPU path of the harness (its look for a card
skipped): the result line the driver reads, the readers, the import guard,
and the command's refusal without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest
from conftest import ROOT, cpu_run, tiny_cell

from harness import spec, trace

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _check_line(line: dict, cell) -> None:
    assert list(line)[:5] == list(KEYS) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"]
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", ["stablelm-3b.train", "rwkv6-3b.serve"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_prints_one_valid_line(name, traced):
    cell = tiny_cell(name)
    line = cpu_run(cell, trace=traced)
    _check_line(line, cell)
    if traced:  # no device trace on the CPU: every reader finds nothing
        assert line["metrics"] == {} and "breakdown" not in line
    else:
        e2e = {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"}
        assert set(line["metrics"]) == e2e
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_the_same_seed_gives_the_same_checks_and_another_seed_others():
    cell = tiny_cell("stablelm-3b.train")
    a, b = cpu_run(cell, seed=7), cpu_run(cell, seed=7)
    c = cpu_run(cell, seed=2 ** 33 + 5)
    assert a["checks"] == b["checks"] and a["checks"] != c["checks"]


def _record(**over):
    kernels = {"bf16::flash_fwd_tc_kernel": [4, 4e-3], "bf16::flash_bwd_dkv_tc_kernel": [2, 6e-3],
               "flash_bwd_dq_tc_kernel": [2, 4e-3], "ncclDevKernel_SendRecv": [10, 0.2],
               "step::wkv6_step_kernel": [64, 3e-3], "wkv6_state_kernel": [2, 5e-4],
               "wkv6_output_kernel": [2, 5e-4], "at::native::elementwise_kernel": [9, 0.5]}
    run = {"platform": "gpu", "chips": 1, "reference": "dense",
           "config": spec.cell(spec.load(ROOT), "stablelm-3b.train", ROOT).arch,
           "traffic": {"kind": "train", "ranks": 1, "batch_per_rank": 2, "seq": 4096},
           "window": {"steps": 10, "seconds": 30.0, "tokens_per_step": 8192},
           "profiled_steps": 2,
           "trace": {"kernels": kernels, "busy_s": 4.5, "window_s": 5.0, "gaps": []},
           "lines": ["prefill: 32 x 1024 tokens in 1.000s (32768.0 tok/s)",
                     "decode: 8160 tokens in 255 steps, 2.000s (4080.0 tok/s), eager"]}
    run.update(over)
    return run


def test_the_readers_read_a_gpu_record_and_nothing_else():
    bench = spec.load(ROOT)
    rwkv = spec.cell(bench, "rwkv6-3b.serve", ROOT)
    serve = {"reference": "rwkv6", "config": rwkv.arch, "traffic": rwkv.traffic,
             "window": {"seconds": 35.0, "batches": 7, "tokens_per_batch": 40928},
             "profiled_batches": 1}
    for m in bench["per_layer"]:
        read = spec.reader(m["name"], ROOT)
        run = _record(**serve) if "serve" in m["name"] else _record()
        value = read(run)
        assert value is not None and value > 0, m["name"]
        if m["unit"] == "%":
            assert value < 100, (m["name"], value)
        assert read(dict(run, platform="cpu")) is None
        if m["source"] == "device_trace":
            assert read(dict(run, trace=None)) is None
    assert spec.reader("idle_share.train", ROOT)(_record()) == pytest.approx(10.0)
    assert spec.reader("nccl_ms.dp4", ROOT)(_record()) == pytest.approx(100.0)
    assert spec.reader("prefill_tokens_per_s.serve", ROOT)(_record()) == pytest.approx(32768)
    assert spec.reader("decode_tokens_per_s.serve", ROOT)(_record()) == pytest.approx(4080)


def test_kernel_names_and_idle_gaps_by_host_activity():
    assert trace.short_name("void bf16::flash_fwd_tc_kernel<80, true>(Params)") == \
        "bf16::flash_fwd_tc_kernel"
    assert trace.short_name("void (anonymous namespace)::k<int>(int)") == "k"
    assert trace.short_name("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)") == \
        "ncclDevKernel_SendRecv"
    host = [(0, 100, "bench.train_step"), (10, 20, "aten::copy_"), (30, 60, "cudaMemcpyAsync")]
    gaps = trace._name_gaps([(12, 18), (40, 50), (70, 90), (120, 130)], host)
    assert [g[0] for g in gaps] == ["bench.train_step", "cudaMemcpyAsync", "(no host event)",
                                    "aten::copy_"]
    assert [g[1] for g in gaps] == pytest.approx([20e-9, 10e-9, 10e-9, 6e-9])


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_the_reduction_drops_span_shadows_and_unites_kernels():
    events = [_Event("bench.window", 0, 1000, False), _Event("bench.window", 0, 1000, True),
              _Event("nccl:coalesced", 100, 500, False), _Event("nccl:coalesced", 200, 700, True),
              _Event("aten::mm", 0, 150, False),
              _Event("void bf16::flash_fwd_tc_kernel<80>(P)", 100, 100, True),
              _Event("ncclDevKernel_SendRecv(S)", 150, 100, True),
              _Event("ncclDevKernel_SendRecv(S)", 600, 100, True)]
    got = trace.reduce(events)
    assert got["kernels"] == {"bf16::flash_fwd_tc_kernel": [1, 1e-7],
                              "ncclDevKernel_SendRecv": [2, 2e-7]}
    assert got["busy_s"] == pytest.approx(250e-9) and got["window_s"] == pytest.approx(1e-6)
    assert sum(g[1] for g in got["gaps"]) == pytest.approx(750e-9)


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    run = _load_run()
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("repro_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlib_fake.x", types.ModuleType("jaxlib_fake.x"))
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("repro.models"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == sorted(set(before) | {"jax", "repro.models"})


def test_the_guard_fails_a_run_that_loaded_jax(monkeypatch, capsys):
    run = _load_run()
    import torch
    cell = tiny_cell("stablelm-3b.train")
    for var in ("TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unused")
    monkeypatch.setattr(spec, "cell", lambda *a, **k: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_rank", lambda args, c: {"checks": {}})
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    code = run.main(["--workload", "stablelm-3b.train", "--seed", "1", "--seconds", "1"])
    assert code == 3 and capsys.readouterr().out == ""


def _load_run():
    import importlib.util
    spec_ = importlib.util.spec_from_file_location("bench_run", ROOT / "bench" / "run.py")
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def test_the_command_refuses_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "stablelm-3b.train",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr
    assert not any(n.split(".")[0] in ("jax", "repro") for n in proc.stderr.split())

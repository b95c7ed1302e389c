"""BENCHMARK.json against the rules it is checked by, and every entry
resolved to its files by name."""
from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

from harness import spec

BENCH = spec.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_paths_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    assert p != "benchmarks" and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word.split("/")
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, CELLS, [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))


def test_cells_pairs_chips_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec.cell(BENCH, cell, ROOT)
    assert c.traffic["kind"] in ("train", "serve")
    ref = c.reference()
    assert callable(ref.draw) and callable(ref.hidden) and callable(ref.logits)
    assert set(c.limits) == ({"loss_gap", "grad_gap", "delta_gap"}
                             if c.traffic["kind"] == "train" else {"logit_gap"})
    assert all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.reader(m["name"], ROOT))
    conf = {x["name"]: x for x in BENCH["configs"]}[c.config["name"]]
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    assert c.config["arch"]["name"] == c.config["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(cell):
    c = spec.cell(BENCH, cell, ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert c.traffic["rate_metric"] in e2e


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers: dict[str, str] = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["layer"].lower(), m["layer"])
        assert layers[m["layer"].lower()] == m["layer"]


def test_roofline_and_mfu_names_carry_percent():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"

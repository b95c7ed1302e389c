"""`BENCHMARK.json` and the files a cell is made of, found by name:

  configuration   the `file` of its `configs` entry (bench/configs/<name>.json)
  traffic mix     bench/traffic/<traffic>.json
  reference       bench/reference/<the configuration's "reference">.py
  limits          bench/limits/<cell>.json (the comparison's limits)
  metric reader   bench/metrics/<metric>.py, one a per-layer metric

A later cell, mix or metric is new files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]   # the checkout
BENCH = ROOT / "bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's parameters
    limits: dict          # {number: limit} of the comparison
    end_to_end: list      # the entries of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def arch(self) -> dict:
        """The sizes the reference reads: the program's fields and the
        block's derived sizes."""
        return {**self.config["arch"], **self.config.get("derived", {})}

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(f"reference.{self.config['reference']}")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its files read; KeyError for an unknown cell."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Cell(
        name=name, chips=work["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "bench" / "traffic" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((root / "bench" / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of a per-layer metric's reader file."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

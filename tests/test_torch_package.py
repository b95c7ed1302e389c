"""The port's package rules: entry points default to the card, and the port
imports neither JAX nor the reference package.

This file imports no JAX, so it also runs on a machine with a card and no JAX.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    cfg = dataclasses.replace(configs.get("stablelm-3b").scaled_down(), dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [serve.Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
                          max_new_tokens=2)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_requests(cfg, model, reqs, max_seq=9, progress=lambda *_: None)
    out = serve.serve_requests(cfg, model, reqs, max_seq=9, progress=lambda *_: None,
                               device="cpu")
    assert len(out[0]) == 2
    tc = train.TrainConfig(steps=1, batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(tc, progress=lambda *_: None)
    _, _, losses = train.train(tc, progress=lambda *_: None, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    # every module of the package was imported: the fabric slice's, the
    # checkpoint store, the verifier, the workloads, and the mesh layer
    assert int(proc.stdout) >= 88
    for name in ("checkpoint.store", "analysis.verifier", "analysis.mutations",
                 "workloads.traces", "workloads.trace_planner", "workloads.online_planner",
                 "workloads.serve", "workloads.tenancy", "workloads.recovery",
                 "launch.mesh", "launch.shardings", "launch.pipeline", "models.sharding"):
        assert (SRC / "repro_torch" / f"{name.replace('.', '/')}.py").exists(), name


def test_port_sources_name_no_jax_and_no_reference_package():
    """The import walk above misses a deferred import inside a function (the
    reference's fabric stack has such imports); no line of the port's
    sources may import `jax` or a `repro` module."""
    pattern = re.compile(r"^\s*(from\s+(repro|jax)[.\s]|import\s+(repro|jax)\b)")
    bad = [f"{path.relative_to(SRC)}:{i}: {line.strip()}"
           for path in sorted((SRC / "repro_torch").rglob("*.py"))
           for i, line in enumerate(path.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad
    assert pattern.match("        from repro.checkpoint import store")
    assert pattern.match("import jax.numpy as jnp") and pattern.match("from jax import lax")
    assert not pattern.match("from repro_torch.core import batchsim")


TWINS = ("torch_quickstart", "torch_schedule_explorer", "torch_serve_decode",
         "torch_train_lm")


@pytest.mark.parametrize("twin", TWINS)
def test_example_twins_import_no_jax_and_no_reference_package(twin):
    """Each twin of an example script, imported in a fresh process, brings in
    neither JAX nor a `repro` module, and no line of it names one."""
    path = SRC.parent / "examples" / f"{twin}.py"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('twin', {str(path)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(from\s+(repro|jax)[.\s]|import\s+(repro|jax)\b)")
    assert not [line for line in path.read_text().splitlines() if pattern.match(line)]

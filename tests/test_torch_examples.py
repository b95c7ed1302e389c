"""Port parity: the port's twins of the example scripts
(`examples/torch_*.py`) against the originals (`examples/*.py`).

serve_decode: the twin's generation from the JAX package's own weights
(converted) and prompt prints the original's ids and agreement, for the
three cache families its docstring names.  train_lm: the twin's first
losses, from converted weights, against the losses the original's call of
the JAX package's `train()` returns (the original stops at its gate after
so few steps).  quickstart and schedule_explorer: stdout equal to the
original's subprocess, line for line.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import both_params, port_cfg  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch.train import model_config as jax_model_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-4   # tests/test_torch_train.py


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(script: str, *args) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args], env=env,
                          capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _checks(lines) -> list[str]:
    """The lines that do not carry a wall time."""
    return [ln for ln in lines if ln.startswith(("generated ids", "greedy agreement"))]


@pytest.mark.parametrize("arch", ["gemma3-4b", "minicpm3-4b", "rwkv6-3b"])
def test_serve_twin_prints_the_originals_ids_and_agreement(arch, monkeypatch, capsys):
    original = _load("serve_decode")
    monkeypatch.setattr(sys, "argv", ["serve_decode.py", "--arch", arch])
    original.main()
    want = _checks(capsys.readouterr().out.splitlines())
    assert len(want) == 2

    jcfg = jax_configs.get(arch).scaled_down()
    _, model = both_params(jcfg, seed=0)           # the original's PRNGKey(0)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                         jcfg.vocab_size))
    got = []
    gen, agree = _load("torch_serve_decode").generate(
        port_cfg(jcfg), model, torch.from_numpy(prompt), 16, got.append)
    assert _checks(got) == want
    assert gen.shape == (4, 16) and 0 <= agree <= 1


def test_train_twin_tracks_the_originals_losses(monkeypatch):
    """3 steps: the original's TrainConfig reaches the JAX package's `train()`,
    the twin's the port's, from the same converted weights."""
    original, twin = _load("train_lm"), _load("torch_train_lm")
    seen = {}

    def jax_train(tc, progress):
        seen["jax_tc"] = tc
        seen["want"] = original_train(tc, progress)[2]
        return None, None, seen["want"]

    original_train = original.train
    monkeypatch.setattr(original, "train", jax_train)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "3"])
    with pytest.raises(AssertionError, match="failed to learn"):
        original.main()

    def port(tc, progress, device):
        _, model = both_params(jax_model_config(seen["jax_tc"]), seed=tc.seed)
        seen["tc"] = tc
        out = port_train.train(tc, progress=progress, device=device, model=model)
        seen["got"] = out[2]
        return out

    monkeypatch.setattr(twin, "train", port)
    with pytest.raises(SystemExit, match="failed to learn"):
        twin.main(["--steps", "3", "--device", "cpu"])
    jtc, tc = seen["jax_tc"], seen["tc"]
    assert {k: getattr(tc, k) for k in vars(jtc)} == vars(jtc)
    assert len(seen["got"]) == 3
    np.testing.assert_allclose(seen["got"], seen["want"], rtol=LOSS_RTOL)


def test_quickstart_twin_prints_the_originals_lines():
    assert _run("torch_quickstart.py", "--device", "cpu") == _run("quickstart.py")


EXPLORER_ARGS = [("--collective", "rs", "--n", "24", "--m-mb", "2"),
                 ("--collective", "ar", "--n", "12", "--fabric", "ocs"),
                 ("--collective", "a2a", "--n", "24", "--fabric", "ocs-sim", "--overlap", "0.5"),
                 ("--collective", "ar", "--n", "12", "--fabric", "ocs-sim"),
                 ("--trace", "mixed", "--n", "48", "--delta-us", "1000")]


@pytest.mark.parametrize("args", EXPLORER_ARGS, ids=" ".join)
def test_schedule_explorer_twin_prints_the_originals_lines(args):
    want = _run("schedule_explorer.py", *args)
    assert want
    assert _run("torch_schedule_explorer.py", *args, "--device", "cpu") == want

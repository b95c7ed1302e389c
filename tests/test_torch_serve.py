"""Port parity: `repro_torch.launch.serve` vs `repro.launch.serve`."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import both_params  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def _requests(mod, cfg, P, N, B, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                        max_new_tokens=N if i else N - 2)
            for i in range(B)]


def test_serve_tokens_equal_jax():
    """Same converted weights and prompts: the same greedy tokens, with the
    per-request budgets of tests/test_serve.py."""
    cfg = dataclasses.replace(jax_configs.get("stablelm-3b").scaled_down(),
                              dtype="float32", remat=False)
    jp, model = both_params(cfg)
    P, N, B = 12, 5, 3
    want = jax_serve.serve_requests(cfg, jp, _requests(jax_serve, cfg, P, N, B),
                                    max_seq=P + N + 1, progress=lambda *_: None)
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, P, N, B),
                               max_seq=P + N + 1, progress=lambda *_: None,
                               device="cpu")
    assert len(got[0]) == N - 2 and all(len(got[i]) == N for i in (1, 2))
    assert got == want


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_serve_tokens_equal_jax_recurrent(arch):
    """The recurrent archs (states in the caches, B4/B5's plain versions on
    the CPU): the same greedy tokens as `repro.launch.serve`."""
    cfg = dataclasses.replace(jax_configs.get(arch).scaled_down(), dtype="float32",
                              remat=False)
    jp, model = both_params(cfg)
    P, N, B = 12, 5, 3
    want = jax_serve.serve_requests(cfg, jp, _requests(jax_serve, cfg, P, N, B),
                                    max_seq=P + N + 1, progress=lambda *_: None)
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, P, N, B),
                               max_seq=P + N + 1, progress=lambda *_: None,
                               device="cpu")
    assert len(got[0]) == N - 2 and all(len(got[i]) == N for i in (1, 2))
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_serve_tokens_equal_jax_moe(arch):
    """The MoE archs (prefill routes the batch's 36 tokens as one group,
    each decode step the 3 new tokens): the same greedy tokens as
    `repro.launch.serve`."""
    cfg = dataclasses.replace(jax_configs.get(arch).scaled_down(), dtype="float32",
                              remat=False)
    jp, model = both_params(cfg)
    P, N, B = 12, 5, 3
    want = jax_serve.serve_requests(cfg, jp, _requests(jax_serve, cfg, P, N, B),
                                    max_seq=P + N + 1, progress=lambda *_: None)
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, P, N, B),
                               max_seq=P + N + 1, progress=lambda *_: None,
                               device="cpu")
    assert len(got[0]) == N - 2 and all(len(got[i]) == N for i in (1, 2))
    assert got == want


def test_cli_default_arch_is_the_references():
    """The port's `--arch` default is the reference's, read from the source
    of `repro/launch/serve.py`, so that the two cannot drift apart."""
    tree = ast.parse(Path(jax_serve.__file__).read_text())
    defaults = [kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                and node.args and getattr(node.args[0], "value", None) == "--arch"
                for kw in node.keywords if kw.arg == "default"]
    assert len(defaults) == 1
    assert serve.build_parser().parse_args([]).arch == defaults[0] == "rwkv6-3b"

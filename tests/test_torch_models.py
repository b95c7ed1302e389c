"""Port parity: the dense decoder of `repro_torch.models` vs `repro.models`.

Layers get the same numpy inputs; models get the JAX-initialised parameters
converted by `params_from_jax`, so both sides hold identical weights.  All
at f32.  Bounds: layers 1e-5, full forward 1e-4, prefill/decode 2e-3 (the
reference's own prefill/decode bound, tests/test_models_smoke.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import both_params  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.models import decode_step, forward, layers, prefill  # noqa: E402

RNG = np.random.default_rng(7)
LAYER_TOL = {"atol": 1e-5, "rtol": 1e-5}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_rmsnorm_matches_jax():
    x = RNG.standard_normal((2, 5, 48)).astype(np.float32)
    scale = RNG.standard_normal(48).astype(np.float32)
    _close(layers.rmsnorm({"scale": _t(scale)}, _t(x)),
           jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), **LAYER_TOL)


@pytest.mark.parametrize("head_dim", [16, 80])
def test_apply_rope_matches_jax(head_dim):
    """Interleaved pairs (0::2, 1::2), f32 angles from int positions."""
    x = RNG.standard_normal((2, 3, 9, head_dim)).astype(np.float32)
    pos = RNG.integers(0, 600, (2, 9)).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos), 10000.0),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), **LAYER_TOL)


def test_swiglu_matches_jax():
    d, d_ff = 32, 72
    p = {k: RNG.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)), ("w_down", (d_ff, d)))}
    x = RNG.standard_normal((2, 7, d)).astype(np.float32)
    _close(layers.swiglu({k: _t(v) for k, v in p.items()}, _t(x)),
           jax_layers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
           **LAYER_TOL)


def test_embed_unembed_match_jax():
    table = RNG.standard_normal((50, 16)).astype(np.float32)
    w = RNG.standard_normal((16, 50)).astype(np.float32)
    tok = RNG.integers(0, 50, (2, 6)).astype(np.int32)
    x = RNG.standard_normal((2, 6, 16)).astype(np.float32)
    _close(layers.embed({"table": _t(table)}, _t(tok).long()),
           jax_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(tok)), **LAYER_TOL)
    for p in ({"table": table}, {"w": w}):  # tied and untied heads
        got = layers.unembed({k: _t(v) for k, v in p.items()}, _t(x))
        assert got.dtype == torch.float32
        _close(got, jax_layers.unembed({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(x)), **LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_init_gives_the_bits_of_the_expression_it_replaces(dtype):
    """`normal_init` scales its draw in place; the values are the bits of
    `(randn * scale).to(dtype)`, the expression it replaced."""
    got = layers.normal_init(torch.Generator().manual_seed(7), (33, 17), 0.37, dtype)
    x = torch.randn((33, 17), generator=torch.Generator().manual_seed(7), dtype=torch.float32)
    want = (x * 0.37).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_dot_returns_float32_for_bf16():
    x = _t(RNG.standard_normal((3, 8)).astype(np.float32)).bfloat16()
    w = _t(RNG.standard_normal((8, 4)).astype(np.float32)).bfloat16()
    y = layers.dot(x, w)
    assert y.dtype == torch.float32
    _close(y, np.asarray(x.float()) @ np.asarray(w.float()), atol=1e-5, rtol=1e-5)


def _stablelm():
    return dataclasses.replace(jax_configs.get("stablelm-3b").scaled_down(),
                               dtype="float32", remat=False)


def _gemma3(num_layers=14):
    """gemma3 scaled down, window 8: 14 layers = 2 reps of the 6-kind period
    plus a 2-layer remainder segment, so the un-stacking order is exercised."""
    return dataclasses.replace(jax_configs.get("gemma3-4b").scaled_down(),
                               dtype="float32", remat=False, window=8,
                               num_layers=num_layers)


def _moe(arch):
    """A MoE arch scaled down (8 experts top-2, groups of 64 tokens)."""
    return lambda: dataclasses.replace(jax_configs.get(arch).scaled_down(),
                                       dtype="float32", remat=False)


ARCH_CFGS = {"stablelm-3b": _stablelm, "gemma3-4b": _gemma3,
             "qwen3-moe-235b-a22b": _moe("qwen3-moe-235b-a22b"),
             "arctic-480b": _moe("arctic-480b")}


def _tokens(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_forward_matches_jax(arch):
    cfg = ARCH_CFGS[arch]()
    jp, model = both_params(cfg)
    tok = _tokens(cfg, 2, 24)
    want = jax_forward(cfg, jp, {"tokens": jnp.asarray(tok)}, mode="train").logits
    got = forward(model.cfg, model, {"tokens": _t(tok)}, mode="train").logits
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    _close(got, want, atol=1e-4, rtol=1e-4)


def test_prefill_decode_matches_jax():
    """Ported from tests/test_models_smoke.py::test_prefill_decode_matches_forward."""
    cfg = _stablelm()
    jp, model = both_params(cfg)
    seq = 12
    tok = _tokens(cfg, 2, seq, seed=1)
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 2])},
                             max_seq=seq + 4)
    got_p, caches = prefill(model.cfg, model, {"tokens": _t(tok[:, :seq - 2])},
                            max_seq=seq + 4)
    _close(got_p, want_p, atol=2e-3, rtol=2e-3)
    for t in range(seq - 2, seq):
        want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
        got_d, caches = decode_step(model.cfg, model, _t(tok[:, t:t + 1]), caches)
        _close(got_d, want_d, atol=2e-3, rtol=2e-3, err_msg=f"decode step {t}")


def test_sliding_window_ring_buffer_decode_matches_jax():
    """Decode beyond the window (ring buffer), ported from
    tests/test_models_smoke.py::test_sliding_window_ring_buffer_decode: the
    port's decode logits against the JAX full forward."""
    cfg = _gemma3()
    jp, model = both_params(cfg)
    seq = 24  # 3x window
    tok = _tokens(cfg, 1, seq, seed=2)
    ref_logits = jax_forward(cfg, jp, {"tokens": jnp.asarray(tok)}, mode="train").logits
    _, caches = prefill(model.cfg, model, {"tokens": _t(tok[:, :seq - 4])},
                        max_seq=seq + 4)
    assert caches[0]["mix"]["k"].shape[2] == cfg.window  # local layers: ring
    assert caches[5]["mix"]["k"].shape[2] == seq + 4     # global layer
    for t in range(seq - 4, seq):
        got_d, caches = decode_step(model.cfg, model, _t(tok[:, t:t + 1]), caches)
        _close(got_d, ref_logits[:, t, :], atol=2e-3, rtol=2e-3, err_msg=f"t={t}")


@pytest.mark.parametrize("change,error,match", [
    ({"pattern": ("conv",)}, ValueError, "conv"),
])
def test_unported_kinds_raise(change, error, match):
    """A block kind that the reference does not define either raises
    ValueError, as its `init_block` does."""
    from repro_torch.models import init_params
    from repro_torch.models.config import ArchConfig
    cfg = ArchConfig(name="x", family="dense", num_layers=2, d_model=32, num_heads=1,
                     num_kv_heads=1, d_ff=64, vocab_size=16, dtype="float32", **change)
    with pytest.raises(error, match=match):
        model = init_params(cfg, torch.Generator(), device="cpu")
        forward(cfg, model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, mode="train")



@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-9b", "rwkv6-3b", "stablelm-3b",
                                  "qwen3-moe-235b-a22b", "arctic-480b", "minicpm3-4b",
                                  "whisper-base", "internvl2-26b", "command-r-plus-104b"])
def test_port_configs_equal_the_reference(arch):
    """Each config module of the port is a copy of the reference's: the same
    fields, field by field, and the arch is registered in `ARCHS`."""
    from repro_torch import configs
    assert arch in configs.ARCHS
    assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(jax_configs.get(arch))


@pytest.mark.parametrize("arch,shape", jax_configs.cells())
def test_port_cells_and_skips_equal_the_reference(arch, shape):
    """`repro_torch.configs` names the reference's ten archs in its order, the
    same 40 (arch, shape) cells, and for each the same `runnable` answer and
    skip reason."""
    from repro_torch import configs
    assert configs.ARCHS == jax_configs.ARCHS
    assert configs.cells() == jax_configs.cells()
    assert configs.runnable(arch, shape) == jax_configs.runnable(arch, shape)

"""Port parity: the MoE FFN of `repro_torch.models.moe` vs `repro.models.moe`.

The reference test config (tests/test_moe.py: 8 experts top-2, d 16, expert
d_ff 32, groups of 16), JAX-initialised weights converted leaf by leaf, and
numpy inputs from a seed.  Before outputs are compared, the routing must be
equal: each (token, choice)'s expert `top_i`, its slot `pos` within that
expert and whether it is kept (`pos < C`), recomputed for JAX from the
reference's own lines.  Bounds, all f32: the FFN output and aux loss rtol /
atol 1e-5; the scaled-down qwen3-moe and arctic prefill and decode logits
2e-3, the reference's own prefill/decode bound (tests/test_models_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import both_params, port_cfg  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.config import ArchConfig as JaxArchConfig  # noqa: E402
from repro.models.config import MoEConfig as JaxMoEConfig  # noqa: E402
from repro_torch.interop import _leaves  # noqa: E402
from repro_torch.models import decode_step, moe, prefill  # noqa: E402

TOL = {"atol": 1e-5, "rtol": 1e-5}
KEY = jax.random.PRNGKey(11)


def make_cfg(**moe_kw):
    """tests/test_moe.py's config."""
    m = JaxMoEConfig(num_experts=8, top_k=2, d_ff_expert=32, group_size=16, **moe_kw)
    return JaxArchConfig(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                         num_kv_heads=2, d_ff=32, vocab_size=64, ffn="moe", moe=m,
                         dtype="float32")


def jax_routing(p, xg, m):
    """(top_i, pos, keep) of one JAX group xg (G, d), as `_moe_group` computes
    them."""
    g = xg.shape[0]
    probs = jax.nn.softmax(jax_layers.dot(xg, p["router"]), axis=-1)
    _, top_i = jax.lax.top_k(probs, m.top_k)
    oh = jax.nn.one_hot(top_i, m.num_experts, dtype=jnp.int32).reshape(g * m.top_k, -1)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=-1).reshape(g, m.top_k)
    return top_i, pos, pos < jax_moe._capacity(g, m)


CASES = {
    "default": ({}, (2, 64)),
    "vectorized": ({"vectorize_groups": True}, (2, 64)),
    "dropless": ({"capacity_factor": 8.0 / 2}, (1, 32)),
    "capacity_drops": ({"capacity_factor": 0.25}, (1, 64)),
    "padding": ({}, (3, 7)),                 # 21 tokens: 5 zero rows pad 2 groups
    "dense_residual": ({"dense_residual_d_ff": 24}, (2, 20)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    moe_kw, (b, s) = CASES[case]
    cfg = make_cfg(**moe_kw)
    jp = jax_moe.init_moe(cfg, KEY, jnp.float32)
    p = _leaves(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).standard_normal((b, s, 16)).astype(np.float32)

    # routing, group by group, padding rows included
    m, gs = cfg.moe, min(cfg.moe.group_size, b * s)
    flat = np.concatenate([x.reshape(-1, 16), np.zeros(((-b * s) % gs, 16), np.float32)])
    groups = flat.reshape(-1, gs, 16)
    _, _, top_i, pos, keep = moe.route(p, torch.from_numpy(groups), port_cfg(cfg).moe)
    for i, xg in enumerate(groups):
        want = jax_routing(jp, jnp.asarray(xg), m)
        for name, got, w in zip(("top_i", "pos", "keep"), (top_i[i], pos[i], keep[i]), want,
                                strict=True):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=f"{name} group {i}")
    if case == "capacity_drops":
        assert not keep.all()
    if case == "dropless":
        assert keep.all()

    want_y, want_aux = jax_moe.moe_ffn(cfg, jp, jnp.asarray(x))
    y, aux = moe.moe_ffn(port_cfg(cfg), p, torch.from_numpy(x))
    assert y.shape == (b, s, 16) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)


def test_vectorized_groups_identical_to_scanned():
    """The port's two ways of running groups (one after another, all at once) give
    the same output and aux loss, the reference's own check."""
    cfg = port_cfg(make_cfg())
    cfg_vec = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, vectorize_groups=True))
    p = _leaves(jax.tree.map(np.asarray, jax_moe.init_moe(make_cfg(), KEY, jnp.float32)),
                "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 64, 16))
                         .astype(np.float32))
    y1, aux1 = moe.moe_ffn(cfg, p, x)
    y2, aux2 = moe.moe_ffn(cfg_vec, p, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)
    np.testing.assert_allclose(aux1.item(), aux2.item(), rtol=1e-6)


@pytest.mark.parametrize("group,experts,k,cf,want", [
    (64, 8, 2, 1.25, 20), (4, 8, 2, 1.25, 4),        # tests/test_moe.py
    (1024, 128, 8, 1.25, 80), (4, 128, 8, 1.25, 4),  # qwen3-moe: prefill, decode group
    (1000, 8, 2, 0.25, 63)])
def test_capacity_matches_the_reference(group, experts, k, cf, want):
    jm = JaxMoEConfig(num_experts=experts, top_k=k, d_ff_expert=4, capacity_factor=cf)
    m = port_cfg(dataclasses.replace(make_cfg(), moe=jm)).moe
    assert moe._capacity(group, m) == jax_moe._capacity(group, jm) == want


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_prefill_decode_matches_jax(arch):
    """Scaled down (8 experts top-2, groups of 64): prefill of 2 x 40 tokens
    (two groups, the second padded) and three decode steps (one group of 2
    tokens, capacity 4), logits against JAX."""
    cfg = dataclasses.replace(jax_configs.get(arch).scaled_down(), dtype="float32",
                              remat=False)
    jp, model = both_params(cfg)
    seq = 43
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 3])},
                             max_seq=seq + 4)
    got_p, caches = prefill(model.cfg, model, {"tokens": torch.from_numpy(tok[:, :seq - 3])},
                            max_seq=seq + 4)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), atol=2e-3, rtol=2e-3)
    for t in range(seq - 3, seq):
        want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
        got_d, caches = decode_step(model.cfg, model, torch.from_numpy(tok[:, t:t + 1]), caches)
        np.testing.assert_allclose(got_d.detach().numpy(), np.asarray(want_d), atol=2e-3, rtol=2e-3,
                                   err_msg=f"decode step {t}")

"""Port parity: MLA (minicpm3-4b) of `repro_torch` vs `repro.models`.

The latent-cache block, its weight-absorbed decode, the flash op at MLA's
head dims (query/key 96, value 64: the op pads V up to the query head) and
the scaled-down minicpm3-4b end to end, all at f32 on the CPU with the same
numpy inputs and the JAX-initialised weights carried across by
`params_from_jax`.  Bounds: the kernel function 5e-5 (tests/test_kernels.py),
its gradients 1e-4 (the same file's gradient bound), a block 1e-4 (as the
full forward of test_torch_models.py), model logits 2e-3
(tests/test_models_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import assert_trees_close, both_params, port_cfg  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, kernel_bwd, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, decode_step, forward, prefill  # noqa: E402

KERNEL_TOL = {"atol": 5e-5, "rtol": 5e-5}
GRAD_TOL = {"atol": 1e-4, "rtol": 1e-4}
BLOCK_TOL = {"atol": 1e-4, "rtol": 1e-4}
MODEL_TOL = {"atol": 2e-3, "rtol": 2e-3}


def _cfg():
    return dataclasses.replace(jax_configs.get("minicpm3-4b").scaled_down(),
                               dtype="float32", remat=False)


def _np(t):
    return t.detach().float().numpy()


# b, h, sq, sk, d (query/key head), dv (value head), causal
MLA_CASES = [
    (2, 4, 48, 48, 96, 64, True),      # minicpm3-4b's heads: nope 64 + rope 32, v 64
    (1, 3, 40, 40, 24, 16, True),      # the scaled-down config's: 16 + 8, v 16
    (1, 2, 33, 70, 96, 64, False),     # ragged, sq < sk, no mask
]


def _mla_arrays(case, seed=0):
    b, h, sq, sk, d, dv, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, dv))]


@pytest.mark.parametrize("case", MLA_CASES)
def test_flash_op_pads_value_head_to_jax_ref(case):
    """The op at MLA's head dims with the explicit scale (nope + rope)^-0.5:
    V padded to the query head, the output sliced back, against JAX's
    `ref.attention`, which takes the narrower V as it is."""
    d, causal = case[4], case[6]
    q, k, v = _mla_arrays(case)
    scale = d ** -0.5
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=None, scale=scale)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal, None, scale)
    assert got.shape == v.shape[:2] + (q.shape[2], v.shape[3])
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("case", MLA_CASES)
def test_flash_op_gradients_through_padding_match_jax(case):
    """dq, dk and dv through the padding and the slice against jax.grad of
    `ref.attention` with the narrower V."""
    d, causal = case[4], case[6]
    q, k, v = _mla_arrays(case, seed=1)
    g = np.random.default_rng(2).standard_normal(
        (case[0], case[1], case[2], case[5])).astype(np.float32)
    scale = d ** -0.5

    def loss(q_, k_, v_):
        out = jax_ref.attention(q_, k_, v_, causal=causal, window=None, scale=scale)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal, None, scale)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.shape == b_.shape, name
        np.testing.assert_allclose(_np(a), np.asarray(b_), err_msg=name, **GRAD_TOL)


def test_value_head_wider_than_query_head_raises():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="wider"):
        ops.flash_attention(q, q, torch.zeros(1, 1, 4, 32))


def test_forward_takes_d96_and_backward_does_not_yet():
    """B1, B2 and B3 all take MLA's head dim 96: the backward kernels gained
    it with the MLA training path, and their tuple is now the forward's.
    (The name is the one this test had while the backward refused 96.)"""
    assert 96 in kernel.HEAD_DIMS and 96 in kernel_bwd.HEAD_DIMS
    assert kernel_bwd.HEAD_DIMS == kernel.HEAD_DIMS


@pytest.mark.parametrize("case", [c for c in MLA_CASES if c[4] == 96])
def test_plain_bwd_at_d96_with_padded_value_matches_jax_vjp(case):
    """The plain dK/dV and dQ wrappers at D = 96 on V of 64 padded to 96 (what
    the op hands them), from the plain forward's output and logsumexp,
    against `jax.vjp` of the reference's jnp attention on the narrow V: dq
    and dk, and dv's first 64 columns; the padded columns of dV are
    discarded, and dvec = rowsum(dO o O) does not see them, O's padded
    columns being zero."""
    d, causal = case[4], case[6]
    q, k, v = _mla_arrays(case, seed=6)
    g = np.random.default_rng(8).standard_normal(
        (case[0], case[1], case[2], case[5])).astype(np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_ref.attention(q_, k_, v_, causal=causal,
                                                          window=None, scale=scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tv = torch.nn.functional.pad(torch.from_numpy(v), (0, d - v.shape[-1]))
    tg = torch.nn.functional.pad(torch.from_numpy(g), (0, d - g.shape[-1]))
    kw = {"scale": scale, "causal": causal, "window": None}
    o, lse = kernel.flash_attention_fwd_lse(tq, tk, tv, **kw)
    assert not o[..., v.shape[-1]:].any()
    dvec = (tg * o).sum(-1)
    dk, dv = kernel_bwd.flash_attention_bwd_dkv(tq, tk, tv, tg, lse, dvec, **kw)
    dq = kernel_bwd.flash_attention_bwd_dq(tq, tk, tv, tg, lse, dvec, **kw)
    got = (dq, dk, dv[..., :v.shape[-1]])
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.shape == b_.shape, name
        np.testing.assert_allclose(_np(a), np.asarray(b_), err_msg=name, **GRAD_TOL)


def _block_inputs(cfg, seq, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (2, seq)).copy()


def _mla_params(cfg):
    jp = jax_attention.init_mla(cfg, jax.random.PRNGKey(3), jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_mla_block_prefill_matches_jax():
    """Prefill (expanded latents, the flash op with padded V) against JAX's
    `mla_block`: the output and the latent cache written at positions 0..S-1."""
    cfg = _cfg()
    jp, tp = _mla_params(cfg)
    x, pos = _block_inputs(cfg, 10, seed=4)
    jcache = jax_attention.init_mla_cache(cfg, 2, 16, jnp.float32)
    want, jcache = jax_attention.mla_block(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                           cache=jcache)
    cache = attention.init_mla_cache(port_cfg(cfg), 2, 16, torch.float32, "cpu")
    got, cache = attention.mla_block(port_cfg(cfg), tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)
    assert cache["pos"] == int(jcache["pos"]) == 10
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]), err_msg=key,
                                   **BLOCK_TOL)


def test_mla_block_absorbed_decode_matches_jax():
    """Two weight-absorbed decode steps after a prefill, against JAX's: each
    step attends in latent space over the whole cache, masked to spos <= pos."""
    cfg = _cfg()
    jp, tp = _mla_params(cfg)
    x, pos = _block_inputs(cfg, 12, seed=5)
    pcfg = port_cfg(cfg)
    jcache = jax_attention.init_mla_cache(cfg, 2, 16, jnp.float32)
    _, jcache = jax_attention.mla_block(cfg, jp, jnp.asarray(x[:, :10]),
                                        jnp.asarray(pos[:, :10]), cache=jcache)
    cache = attention.init_mla_cache(pcfg, 2, 16, torch.float32, "cpu")
    _, cache = attention.mla_block(pcfg, tp, torch.from_numpy(x[:, :10]),
                                   torch.from_numpy(pos[:, :10]), cache=cache)
    for t in (10, 11):
        want, jcache = jax_attention.mla_block(cfg, jp, jnp.asarray(x[:, t:t + 1]),
                                               jnp.asarray(pos[:, t:t + 1]), cache=jcache)
        got, cache = attention.mla_block(pcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                         torch.from_numpy(pos[:, t:t + 1]), cache=cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=f"step {t}",
                                   **BLOCK_TOL)
        assert cache["pos"] == t + 1
    np.testing.assert_allclose(_np(cache["c_kv"]), np.asarray(jcache["c_kv"]), **BLOCK_TOL)


def _tokens(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)
                                                ).astype(np.int32)


def test_minicpm3_forward_matches_jax():
    cfg = _cfg()
    jp, model = both_params(cfg)
    tok = _tokens(cfg, 2, 20)
    want = jax_forward(cfg, jp, {"tokens": jnp.asarray(tok)}, mode="train").logits
    with torch.no_grad():
        got = forward(model.cfg, model, {"tokens": torch.from_numpy(tok)}, mode="train").logits
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)


def test_minicpm3_prefill_decode_matches_jax():
    cfg = _cfg()
    jp, model = both_params(cfg)
    seq = 12
    tok = _tokens(cfg, 2, seq, seed=1)
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 2])},
                             max_seq=seq + 4)
    with torch.no_grad():
        got_p, caches = prefill(model.cfg, model, {"tokens": torch.from_numpy(tok[:, :seq - 2])},
                                max_seq=seq + 4)
        np.testing.assert_allclose(_np(got_p), np.asarray(want_p), **MODEL_TOL)
        for t in range(seq - 2, seq):
            want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
            got_d, caches = decode_step(model.cfg, model, torch.from_numpy(tok[:, t:t + 1]),
                                        caches)
            np.testing.assert_allclose(_np(got_d), np.asarray(want_d),
                                       err_msg=f"decode step {t}", **MODEL_TOL)


def test_minicpm3_interop_round_trips():
    """params_from_jax then tree_from_model gives back the JAX tree, leaf by leaf."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    assert_trees_close(tree_from_model(model), jp, atol=0, rtol=0)


def _requests(mod, cfg, P, N, B, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                        max_new_tokens=N if i else N - 2)
            for i in range(B)]


def test_minicpm3_serve_tokens_equal_jax():
    """The scaled-down minicpm3-4b through both serving drivers: the same
    greedy tokens, with the per-request budgets of tests/test_serve.py."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    P, N, B = 12, 5, 3
    want = jax_serve.serve_requests(cfg, jp, _requests(jax_serve, cfg, P, N, B),
                                    max_seq=P + N + 1, progress=lambda *_: None)
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, P, N, B),
                               max_seq=P + N + 1, progress=lambda *_: None, device="cpu")
    assert len(got[0]) == N - 2 and all(len(got[i]) == N for i in (1, 2))
    assert got == want

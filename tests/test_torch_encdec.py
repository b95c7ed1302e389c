"""Port parity: whisper-base's encoder-decoder of `repro_torch` vs `repro.models`.

The layers it adds (the tanh-GELU MLP, sinusoidal positions, layernorm),
bidirectional and cross attention, the flash op without a mask at Sq < Sk
against the Pallas kernel (interpret mode), and the scaled-down whisper-base
end to end: `_encode`, the prefill logits, the cross K/V caches and two
decode steps against JAX's `prefill` and `decode_step`.  All f32 on the CPU,
the same numpy inputs, the JAX-initialised weights carried across by
`params_from_jax`.  Bounds: layers 1e-5 (test_torch_models.py), the kernel
function 5e-5 (tests/test_kernels.py), blocks and the encoder 1e-4, model
logits 2e-3 (tests/test_models_smoke.py).
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
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import attention, decode_step, forward, layers, prefill  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402

RNG = np.random.default_rng(11)
LAYER_TOL = {"atol": 1e-5, "rtol": 1e-5}
KERNEL_TOL = {"atol": 5e-5, "rtol": 5e-5}
BLOCK_TOL = {"atol": 1e-4, "rtol": 1e-4}
MODEL_TOL = {"atol": 2e-3, "rtol": 2e-3}


def _cfg():
    return dataclasses.replace(jax_configs.get("whisper-base").scaled_down(),
                               dtype="float32", remat=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def test_gelu_mlp_is_the_tanh_approximation_of_jax():
    """`jax.nn.gelu` defaults to tanh; the port names it (F.gelu's default is
    erf, which differs from it by up to ~1e-3 and fails this bound)."""
    d, d_ff = 32, 80
    p = {"w_in": RNG.standard_normal((d, d_ff)).astype(np.float32) * 0.3,
         "b_in": RNG.standard_normal(d_ff).astype(np.float32),
         "w_out": RNG.standard_normal((d_ff, d)).astype(np.float32) * 0.2,
         "b_out": RNG.standard_normal(d).astype(np.float32)}
    x = RNG.standard_normal((2, 7, d)).astype(np.float32) * 2
    want = jax_layers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    h = x @ p["w_in"] + p["b_in"]
    erf = (torch.nn.functional.gelu(_t(h)).numpy() @ p["w_out"]) + p["b_out"]
    assert np.abs(erf - np.asarray(want)).max() > 10 * LAYER_TOL["atol"]


@pytest.mark.parametrize("seq,d", [(24, 128), (1500, 512)])
def test_sinusoidal_positions_match_jax(seq, d):
    """Whisper's encoder table, at the scaled-down and at the full size."""
    want = jax_layers.sinusoidal_positions(seq, d)
    got = layers.sinusoidal_positions(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_layernorm_matches_jax():
    x = RNG.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": RNG.standard_normal(48).astype(np.float32),
         "bias": RNG.standard_normal(48).astype(np.float32)}
    want = jax_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.layernorm({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    init = layers.init_layernorm(48, torch.float32, "cpu")
    want_init = jax_layers.init_layernorm(48, jnp.float32)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(want_init[k]))


# b, hq, hkv, sq, sk, d: no mask, Sq < Sk (cross attention: prefill and one
# decode query) and Sq = Sk (the encoder)
NOMASK_CASES = [(2, 4, 4, 8, 40, 32), (2, 4, 2, 1, 40, 32), (1, 2, 2, 30, 30, 16)]


@pytest.mark.parametrize("case", NOMASK_CASES)
def test_flash_op_without_mask_matches_pallas_interpret(case):
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    b, hq, hkv, sq, sk, d = case
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, None,
                     interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), False, None)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


def _attn_params(cfg, seed):
    jp = jax_attention.init_attention(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def test_bidirectional_attention_block_matches_jax():
    cfg = _cfg()
    jp, tp = _attn_params(cfg, 1)
    s = 20
    x = RNG.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    want, _ = jax_attention.attention_block(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                            kind="attn", bidirectional=True)
    got, _ = attention.attention_block(port_cfg(cfg), tp, _t(x), _t(pos), kind="attn",
                                       bidirectional=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)
    causal, _ = attention.attention_block(port_cfg(cfg), tp, _t(x), _t(pos), kind="attn")
    assert not np.allclose(_np(causal), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("s", [9, 1])
def test_cross_attention_matches_jax(s):
    """encode_cross_kv and cross_attention_block: the prompt (s = 9) and one
    decode query (s = 1) against every encoder frame."""
    cfg = _cfg()
    jp, tp = _attn_params(cfg, 2)
    enc = RNG.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    x = RNG.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jkv = jax_attention.encode_cross_kv(cfg, jp, jnp.asarray(enc))
    kv = attention.encode_cross_kv(port_cfg(cfg), tp, _t(enc))
    for got, want in zip(kv, jkv, strict=True):
        assert got.is_contiguous()
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    want = jax_attention.cross_attention_block(cfg, jp, jnp.asarray(x), jkv)
    got = attention.cross_attention_block(port_cfg(cfg), tp, _t(x), kv)
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)


def _inputs(cfg, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    frames = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tok, frames


def test_whisper_encode_matches_jax():
    """The encoder: sinusoid added, RoPE inside each bidirectional block,
    the decoder's final_norm at the end."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    _, frames = _inputs(cfg, 2, 4)
    want = jax_model._encode(cfg, jp, jnp.asarray(frames))
    with torch.no_grad():
        got = port_model._encode(model.cfg, model, _t(frames))
    assert len(model.encoder) == cfg.num_encoder_layers
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)


def test_whisper_forward_matches_jax():
    cfg = _cfg()
    jp, model = both_params(cfg)
    tok, frames = _inputs(cfg, 2, 14, seed=1)
    want = jax_forward(cfg, jp, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames)},
                       mode="train").logits
    with torch.no_grad():
        got = forward(model.cfg, model, {"tokens": _t(tok), "frames": _t(frames)},
                      mode="train").logits
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)


def test_whisper_prefill_cross_caches_and_decode_match_jax():
    """The port encodes once in prefill and fills each layer's cross K/V in
    that forward; JAX encodes again in `_fill_cross_kv`.  The caches hold
    the same values; the prefill logits and two decode steps agree."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    seq = 12
    tok, frames = _inputs(cfg, 2, seq, seed=2)
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 2]),
                                       "frames": jnp.asarray(frames)}, max_seq=seq + 4)
    with torch.no_grad():
        got_p, caches = prefill(model.cfg, model, {"tokens": _t(tok[:, :seq - 2]),
                                                   "frames": _t(frames)}, max_seq=seq + 4)
        np.testing.assert_allclose(_np(got_p), np.asarray(want_p), **MODEL_TOL)
        layer = 0
        for si, (kinds, reps) in enumerate(jax_model.segments(cfg)):
            for rep in range(reps):
                for pos in range(len(kinds)):
                    for key in ("cross_k", "cross_v"):
                        want = np.asarray(jc[si][pos][key])[rep]
                        got = caches[layer][key]
                        assert got.shape == want.shape, key
                        np.testing.assert_allclose(_np(got), want, err_msg=f"{layer} {key}",
                                                   **BLOCK_TOL)
                    layer += 1
        assert layer == cfg.num_layers
        for t in range(seq - 2, seq):
            want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
            got_d, caches = decode_step(model.cfg, model, _t(tok[:, t:t + 1]), caches)
            np.testing.assert_allclose(_np(got_d), np.asarray(want_d),
                                       err_msg=f"decode step {t}", **MODEL_TOL)


def test_whisper_prefill_runs_the_flash_op_once_per_encoder_self_and_cross_call(monkeypatch):
    """Prefill calls the flash op 6 + 6 + 6 times at whisper-base's depth
    (the scaled-down 2 + 4 + 4 here): each encoder layer, each decoder self
    attention and each cross attention once; the encoder runs once.  A
    decode step calls it once per cross attention only."""
    cfg = _cfg()
    _, model = both_params(cfg)
    calls = []
    flash = attention.flash_attention

    def counting(q, k, v, causal, *args):
        calls.append((q.shape[2], k.shape[2], causal))
        return flash(q, k, v, causal, *args)

    monkeypatch.setattr(attention, "flash_attention", counting)
    tok, frames = _inputs(cfg, 1, 6, seed=3)
    with torch.no_grad():
        _, caches = prefill(model.cfg, model, {"tokens": _t(tok), "frames": _t(frames)},
                            max_seq=10)
        enc, n = cfg.encoder_seq, cfg.num_layers
        assert calls == ([(enc, enc, False)] * cfg.num_encoder_layers
                         + [(6, 6, True), (6, enc, False)] * n)
        calls.clear()
        decode_step(model.cfg, model, _t(tok[:, :1]), caches)
        assert calls == [(1, enc, False)] * n


def test_whisper_prefill_writes_the_cross_caches_in_place():
    """The cross K/V go into the tensors that `init_caches` allocated, as
    every cache of the port is written: the same objects, the same storage,
    and they equal the encoder output's K/V."""
    cfg = _cfg()
    _, model = both_params(cfg)
    tok, frames = _inputs(cfg, 2, 5, seed=4)
    caches = port_model.init_caches(model.cfg, 2, 8, model.device)
    before = [(c["cross_k"], c["cross_v"], c["cross_k"].data_ptr()) for c in caches]
    with torch.no_grad():
        out = forward(model.cfg, model, {"tokens": _t(tok), "frames": _t(frames)},
                      caches=caches, mode="prefill")
        enc = port_model._encode(model.cfg, model, _t(frames))
        for c, (k, v, ptr), blk in zip(out.caches, before, model.blocks, strict=True):
            assert c["cross_k"] is k and c["cross_v"] is v and k.data_ptr() == ptr
            want_k, want_v = attention.encode_cross_kv(model.cfg, blk["cross"], enc)
            assert torch.equal(k, want_k) and torch.equal(v, want_v)


def test_whisper_without_frames_raises():
    cfg = _cfg()
    _, model = both_params(cfg)
    with pytest.raises(ValueError, match="frames"):
        forward(model.cfg, model, {"tokens": torch.zeros((1, 3), dtype=torch.int32)})


def test_whisper_interop_round_trips():
    """params_from_jax then tree_from_model gives back the JAX tree, the
    encoder segment and the decoder's cross leaves included."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    tree = tree_from_model(model)
    assert "encoder" in tree and "cross" in tree["decoder"][0][0]
    assert_trees_close(tree, jp, atol=0, rtol=0)

"""Port parity: internvl2-26b's `patch_stub` frontend of `repro_torch` vs
`repro.models`.

Precomputed patch embeddings (B, frontend_seq, d), projected by
`patch_proj` and prepended to the token embeddings; positions run over
patches and tokens together.  The scaled-down internvl2-26b's forward with
patches, its prefill and decode steps against JAX's, and the interop round
trip.  All f32 on the CPU, the same numpy inputs, the JAX-initialised
weights carried across by `params_from_jax`.  Bounds: the full forward 1e-4
(test_torch_models.py), prefill and decode logits 2e-3
(tests/test_models_smoke.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import assert_trees_close, both_params  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402

FORWARD_TOL = {"atol": 1e-4, "rtol": 1e-4}
MODEL_TOL = {"atol": 2e-3, "rtol": 2e-3}


def _cfg():
    return dataclasses.replace(jax_configs.get("internvl2-26b").scaled_down(),
                               dtype="float32", remat=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _inputs(cfg, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    patches = rng.standard_normal((batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tok, patches


def test_embed_inputs_prepend_projected_patches():
    """The embedded inputs and their positions against JAX's `_embed_inputs`."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    tok, patches = _inputs(cfg, 2, 7)
    want_x, want_pos = jax_model._embed_inputs(cfg, jp, {"tokens": jnp.asarray(tok),
                                                         "patches": jnp.asarray(patches)})
    with torch.no_grad():
        x, pos = port_model._embed_inputs(model.cfg, model, {"tokens": _t(tok),
                                                             "patches": _t(patches)})
    assert x.shape == (2, cfg.frontend_seq + 7, cfg.d_model)
    np.testing.assert_allclose(_np(x), np.asarray(want_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))


@pytest.mark.parametrize("with_patches", [True, False])
def test_internvl2_forward_matches_jax(with_patches):
    """With patches the logits cover patches and tokens; without, the
    backbone runs on tokens alone, as in the reference."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    tok, patches = _inputs(cfg, 2, 12, seed=1)
    batch = {"tokens": tok, **({"patches": patches} if with_patches else {})}
    want = jax_forward(cfg, jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       mode="train").logits
    with torch.no_grad():
        got = forward(model.cfg, model, {k: _t(v) for k, v in batch.items()},
                      mode="train").logits
    assert got.shape == (2, 12 + cfg.frontend_seq * with_patches, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FORWARD_TOL)


def test_internvl2_prefill_decode_matches_jax():
    """Prefill over patches and prompt, then two decode steps whose
    positions continue after the patch prefix."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    seq = 12
    tok, patches = _inputs(cfg, 2, seq, seed=2)
    max_seq = cfg.frontend_seq + seq + 4
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 2]),
                                       "patches": jnp.asarray(patches)}, max_seq=max_seq)
    with torch.no_grad():
        got_p, caches = prefill(model.cfg, model, {"tokens": _t(tok[:, :seq - 2]),
                                                   "patches": _t(patches)}, max_seq=max_seq)
        np.testing.assert_allclose(_np(got_p), np.asarray(want_p), **MODEL_TOL)
        assert int(caches[0]["mix"]["pos"]) == cfg.frontend_seq + seq - 2
        for t in range(seq - 2, seq):
            want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
            got_d, caches = decode_step(model.cfg, model, _t(tok[:, t:t + 1]), caches)
            np.testing.assert_allclose(_np(got_d), np.asarray(want_d),
                                       err_msg=f"decode step {t}", **MODEL_TOL)


def test_internvl2_interop_round_trips():
    """params_from_jax then tree_from_model gives back the JAX tree,
    `patch_proj` included."""
    cfg = _cfg()
    jp, model = both_params(cfg)
    tree = tree_from_model(model)
    assert "patch_proj" in tree and model.patch_proj is not None
    assert_trees_close(tree, jp, atol=0, rtol=0)


def test_patch_proj_only_with_the_patch_frontend():
    from repro_torch.models import Model
    cfg = _cfg()
    _, model = both_params(cfg)
    with pytest.raises(ValueError, match="patch_proj"):
        Model(model.cfg, {"table": model.embed["table"].data}, None,
              {"scale": model.final_norm["scale"].data},
              [{}] * cfg.num_layers)

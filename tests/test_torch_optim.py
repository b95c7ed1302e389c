"""Port parity: `repro_torch.optim` (AdamW, clipping, cosine schedule) vs
`repro.optim`, step by step on the same gradients, at rtol 1e-6 (the same
f32 arithmetic in the same order; only the order of the norm's sum may
differ)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402

from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_warmup_schedule as jax_schedule  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,  # noqa: E402
                               cosine_warmup_schedule)

RTOL = 1e-6
SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}  # sorted: the JAX leaf order


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=0, err_msg=what)


def _grads(rng, clipped):
    """Unclipped: a global norm ~0.3, so the clip factor is exactly 1.
    Clipped: entries +-2^30 (the size of tests/test_fault_tolerance.py's 1e9
    case), whose squares and their sums are exact in f32 in any order, so both
    sides get the same clip factor bit for bit: the moments then follow the
    same rounded arithmetic, where m = 0.9 m + 0.1 g may cancel and would turn
    a last-bit difference in the norm into a large relative one."""
    if clipped:
        return {k: rng.choice([-1.0, 1.0], s).astype(np.float32) * 2.0 ** 30
                for k, s in SHAPES.items()}
    return {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
def test_adamw_steps_match_jax(clipped):
    """5 steps of warmup (2) then cosine decay, with or without clipping."""
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jax_adamw_init(jp)
    params = [torch.from_numpy(init[k].copy()) for k in SHAPES]
    state = adamw_init(params)
    jlr, lr = jax_schedule(1e-2, 2, 5), cosine_warmup_schedule(1e-2, 2, 5)
    for step in range(5):
        g = _grads(rng, clipped)
        jp, jstate, jm = jax_adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                          jstate, jp, jlr)
        _, state, m = adamw_update([torch.from_numpy(g[k]) for k in SHAPES], state,
                                   params, lr)
        assert int(state.step) == int(jstate.step) == step + 1
        _close(m["grad_norm"], jm["grad_norm"], f"grad_norm, step {step}")
        _close(m["lr"], jm["lr"], f"lr, step {step}")
        for i, k in enumerate(SHAPES):
            _close(params[i], jp[k], f"param {k}, step {step}")
            _close(state.m[i], jstate.m[k], f"m {k}, step {step}")
            _close(state.v[i], jstate.v[k], f"v {k}, step {step}")
            assert state.m[i].dtype == state.v[i].dtype == torch.float32
        if clipped:
            norm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g.values()))
            assert float(m["grad_norm"]) == pytest.approx(norm, rel=1e-3)


def test_clip_and_schedule_match_jax():
    rng = np.random.default_rng(1)
    g = [rng.standard_normal(s).astype(np.float32) * 3 for s in SHAPES.values()]
    clipped, gnorm = clip_by_global_norm([torch.from_numpy(a) for a in g], 1.0)
    _close(gnorm, np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a in g)), "norm")
    _close(sum(float(torch.sum(c * c)) for c in clipped), 1.0, "clipped norm")
    jlr, lr = jax_schedule(1e-3, 10, 100), cosine_warmup_schedule(1e-3, 10, 100)
    for step in (0, 5, 9, 10, 20, 55, 99, 150):
        _close(lr(torch.tensor(step, dtype=torch.int32)),
               jlr(jnp.asarray(step, jnp.int32)), f"lr({step})")


def test_sharded_adamw_equals_the_whole_update(tmp_path):
    """AdamW on DTensor shards over (2, 2) (sharded on both axes, on one,
    replicated): the global norm counts each leaf once and every shard's
    update is the whole update's, against `adamw_update` on whole tensors."""
    out = tmp_path / "adamw.npz"
    spawn("adamw", 4, str(out), timeout=120)
    r = np.load(out)
    np.testing.assert_allclose(r["gnorm"], r["want_gnorm"], rtol=1e-6)
    for i in range(int(r["leaves"])):
        np.testing.assert_allclose(r[f"p{i}"], r[f"want_p{i}"], rtol=1e-6, atol=1e-7)

"""Port parity: the recurrent archs of `repro_torch` (RG-LRU, kernel B4; RWKV-6,
kernel B5) vs the JAX package.

The same numpy inputs (from a seed) go through the JAX function and the port.
The kernels' plain versions are held to the JAX Pallas kernels in interpret
mode and to the JAX reference scans, at the reference's bounds
(tests/test_kernels.py): B4 5e-5 (f32) / 5e-2 (bf16); B5 y and state 5e-4
(f32), y 5e-2 (bf16); extreme decay 1e-4.  Blocks at 1e-5, full forward
1e-4, prefill/decode 2e-3, all in f32.  A plain emulation of B5's bf16
two-pass design (its chunks, sub-blocks, factored operands and TF32
rounding) is held to the JAX kernel and scan at the bf16 bounds.  On the
card B4 also equals its plain version bit for bit in f32.  Cases that need
the card carry the `cuda` marker and skip without one; they need no JAX, so
on a machine with a card and no JAX they run with
`python -m pytest -m cuda tests/test_torch_recurrent.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

try:  # the card's machine has no JAX: there only the `cuda` cases run (-m cuda)
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_trees_close, both_params, port_cfg

    from repro import configs as jax_configs
    from repro.kernels.rg_lru import ref as jax_lru_ref
    from repro.kernels.rg_lru.ops import rg_lru as jax_rg_lru
    from repro.kernels.wkv6 import ref as jax_wkv_ref
    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
    from repro.models import decode_step as jax_decode_step
    from repro.models import forward as jax_forward
    from repro.models import prefill as jax_prefill
    from repro.models import recurrent as jax_recurrent
except ModuleNotFoundError:
    jax = None

from repro_torch.kernels.rg_lru import kernel as lru_kernel  # noqa: E402
from repro_torch.kernels.rg_lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ref as lru_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.models import decode_step, forward, prefill, recurrent  # noqa: E402

DTYPES = ("float32", "bfloat16")
LRU_CASES = [(2, 100, 48), (1, 256, 128), (3, 17, 8), (1, 1, 16)]  # B, T, D
WKV_CASES = [(2, 3, 50, 16, 16), (1, 2, 64, 32, 32), (1, 1, 7, 8, 8),
             (2, 2, 33, 64, 64)]                                      # B, H, T, dk, dv
BLOCK_TOL = {"atol": 1e-5, "rtol": 1e-5}


def lru_tol(dtype):
    return ({"atol": 5e-2, "rtol": 5e-2} if dtype == "bfloat16"
            else {"atol": 5e-5, "rtol": 5e-5})


def wkv_tol(dtype):
    return ({"atol": 5e-2, "rtol": 5e-2} if dtype == "bfloat16"
            else {"atol": 5e-4, "rtol": 5e-4})


STATE_TOL = {"atol": 5e-4, "rtol": 5e-4}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    """(JAX array, torch tensor) of the same f32 numpy values, both rounded to
    `dtype` (nearest-even bf16 on both sides)."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _lru_arrays(shape, seed, h0=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal((shape[0], shape[2])).astype(np.float32) if h0 else None
    return a, b, h


def _wkv_arrays(dims, seed, s0=False):
    bsz, heads, steps, dk, dv = dims
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((bsz, heads, steps, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((bsz, heads, steps, dv)).astype(np.float32)
    lw = -np.exp(rng.standard_normal((bsz, heads, steps, dk))).astype(np.float32)
    u = rng.standard_normal((heads, dk)).astype(np.float32)
    s = rng.standard_normal((bsz, heads, dk, dv)).astype(np.float32) if s0 else None
    return r, k, v, lw, u, s


# --- B4: the plain version vs the JAX kernel and scan ---------------------------


@pytest.mark.parametrize("shape", LRU_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_rg_lru_matches_jax_kernel(shape, dtype):
    a, b, _ = _lru_arrays(shape, seed=0)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    want_y, want_h = jax_rg_lru(ja, jb)                     # Pallas, interpret mode
    got_y, got_h = lru_kernel.rg_lru_fwd(ta, tb)            # CPU: the plain version
    assert got_y.dtype == ta.dtype and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **lru_tol(dtype))
    np.testing.assert_allclose(_np(got_h), _np(want_h), **lru_tol(dtype))


# (2, 1100, 48): a T over many stages of the CUDA kernel's ring (16 steps a
# stage), not a multiple of the stage
@pytest.mark.parametrize("shape", [(2, 100, 48), (3, 17, 8), (4, 1, 64), (2, 1100, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_rg_lru_from_h0_matches_jax_scan(shape, dtype):
    a, b, h0 = _lru_arrays(shape, seed=1, h0=True)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    want_y, want_h = jax_lru_ref.rg_lru_scan(ja, jb, jnp.asarray(h0))
    got_y, got_h = lru_ops.rg_lru(ta, tb, torch.from_numpy(h0))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **lru_tol(dtype))
    np.testing.assert_allclose(_np(got_h), _np(want_h), **lru_tol(dtype))


def test_rg_lru_grad_on_cpu_matches_jax():
    """On the CPU the op's gradient is the plain backward, as the JAX op
    differentiates its reference scan (tests/test_kernels.py)."""
    a, b, _ = _lru_arrays((1, 20, 8), seed=2)
    want = jax.grad(lambda a_, b_: jax_rg_lru(a_, b_)[0].sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = torch.autograd.grad(lru_ops.rg_lru(ta, tb)[0].sum(), (ta, tb))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


# --- B5: the plain version vs the JAX kernel and scan ---------------------------


@pytest.mark.parametrize("dims", WKV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_wkv6_matches_jax_kernel(dims, dtype):
    r, k, v, lw, u, _ = _wkv_arrays(dims, seed=0)
    pairs = [_pair(x, dtype) for x in (r, k, v, lw, u)]
    want_y, want_s = jax_wkv6(*(j for j, _ in pairs))     # Pallas, interpret mode
    got_y, got_s, _ = wkv_kernel.wkv6_fwd(*(t for _, t in pairs))  # CPU: the plain version
    assert got_y.dtype == pairs[0][1].dtype and got_s.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **wkv_tol(dtype))
    np.testing.assert_allclose(_np(got_s), _np(want_s), **STATE_TOL)


@pytest.mark.parametrize("dims", [(2, 3, 50, 16, 16), (2, 2, 33, 64, 64), (4, 3, 1, 64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_wkv6_from_s0_matches_jax_scan(dims, dtype):
    """The model's inputs: r, k, v, log_w in the activation dtype, f32 bonus
    and f32 state; T = 1 is a decode step."""
    r, k, v, lw, u, s0 = _wkv_arrays(dims, seed=1, s0=True)
    (jr, tr), (jk, tk), (jv, tv), (jl, tl) = (_pair(x, dtype) for x in (r, k, v, lw))
    want_y, want_s = jax_wkv_ref.wkv6_scan(jr, jk, jv, jnp.exp(jl.astype(jnp.float32)),
                                           jnp.asarray(u), jnp.asarray(s0))
    got_y, got_s = wkv_ops.wkv6(tr, tk, tv, tl, torch.from_numpy(u), torch.from_numpy(s0))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **wkv_tol(dtype))
    np.testing.assert_allclose(_np(got_s), _np(want_s), **STATE_TOL)


def test_plain_wkv6_extreme_decay_matches_jax():
    """log_w = -20 (near-total forgetting each step), as
    tests/test_kernels.py::test_wkv6_extreme_decay_stable."""
    r, k, v, _, _, _ = _wkv_arrays((1, 1, 64, 16, 16), seed=3)
    lw = np.full(r.shape, -20.0, np.float32)
    u = np.ones((1, 16), np.float32)
    want_y, _ = jax_wkv6(*(jnp.asarray(x) for x in (r, k, v, lw, u)))
    want_ref, _ = jax_wkv_ref.wkv6_scan(*(jnp.asarray(x) for x in (r, k, v, np.exp(lw), u)))
    got_y, _ = wkv_ops.wkv6(*(torch.from_numpy(x) for x in (r, k, v, lw, u)))
    assert np.isfinite(_np(got_y)).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(got_y), _np(want_ref), atol=1e-4, rtol=1e-4)


def test_wkv6_grad_on_cpu_matches_jax():
    """On the CPU the op's gradient is the plain backward, as the JAX op
    differentiates its reference scan."""
    arrays = _wkv_arrays((1, 2, 12, 8, 8), seed=4)[:5]
    want = jax.grad(lambda *xs: jax_wkv6(*xs)[0].sum(), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in arrays))
    ts = [torch.from_numpy(x).requires_grad_() for x in arrays]
    got = torch.autograd.grad(wkv_ops.wkv6(*ts)[0].sum(), ts)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


# --- B5's two-pass design, emulated ------------------------------------------------


def _tf32(x):
    """f32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _wkv6_two_pass_emulation(r, k, v, log_w, u, s0=None, chunk=64, sub=16):
    """What B5's bf16 two-pass design computes, in plain PyTorch: per chunk of
    64 steps, y = A V + (r e^{c_{t-1}}) S_in.  A's rows come in sub-blocks of
    16: left of the diagonal sub-block from factored operands against the
    step before it (r~ and k~, rounded to TF32); in the diagonal sub-block,
    the lower-left 8 x 8 quarter likewise against the step before its rows,
    the two diagonal 8 x 8 quarters from per-element exps, with the bonus on
    the diagonal.  A and S_in are rounded to TF32 before their products.  The
    state S_out = e^{c_last} S_in + k~^T V, k~ = k e^{c_last - c}, takes k~ as
    the sum of its TF32 value and the TF32 value of the rest (3xTF32 whose
    third product vanishes: v is exact in TF32)."""
    bsz, heads, steps, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, lw = (x.float() for x in (r, k, v, log_w))
    uf = u.float()[None, :, None, :]
    s = torch.zeros(bsz, heads, dk, dv) if s0 is None else s0.float()
    ys = []

    def factored(rows, cols, ref):  # A[rows, cols] against c_ref, all cols < all rows
        ref_c = c[:, :, ref:ref + 1]
        r_t = _tf32(rc[:, :, rows] * torch.exp(cprev[:, :, rows] - ref_c))
        k_t = _tf32(kc[:, :, cols] * torch.exp(ref_c - c[:, :, cols]))
        return r_t @ k_t.transpose(-1, -2)

    for t0 in range(0, steps, chunk):
        n = min(chunk, steps - t0)
        rc, kc, vc = rf[:, :, t0:t0 + n], kf[:, :, t0:t0 + n], vf[:, :, t0:t0 + n]
        c = torch.cumsum(lw[:, :, t0:t0 + n], dim=2)                       # c_t
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)  # c_{t-1}
        a = torch.zeros(bsz, heads, n, n)
        for i0 in range(0, n, sub):
            m = min(sub, n - i0)
            for q0 in range(i0, i0 + m, 8):          # the diagonal 8 x 8 quarters
                rows = slice(q0, min(q0 + 8, i0 + m))
                qm = rows.stop - q0
                strict = torch.ones(qm, qm, dtype=torch.bool).tril(-1)[:, :, None]
                expo = cprev[:, :, rows, None, :] - c[:, :, None, rows, :]
                decay = torch.exp(torch.where(strict, expo, torch.tensor(float("-inf"))))
                a[:, :, rows, rows] = torch.einsum(
                    "bhtd,bhjd,bhtjd->bhtj", rc[:, :, rows], kc[:, :, rows], decay) \
                    + torch.diag_embed((rc[:, :, rows] * uf * kc[:, :, rows]).sum(-1))
            if m > 8:                                 # the lower-left quarter
                a[:, :, i0 + 8:i0 + m, i0:i0 + 8] = factored(
                    slice(i0 + 8, i0 + m), slice(i0, i0 + 8), i0 + 7)
            if i0 > 0:                                # left of the diagonal sub-block
                a[:, :, i0:i0 + m, :i0] = factored(slice(i0, i0 + m), slice(0, i0), i0 - 1)
        ys.append(_tf32(a) @ vc + _tf32(rc * torch.exp(cprev)) @ _tf32(s))
        c_last = c[:, :, -1]
        k_t = kc * torch.exp(c_last[:, :, None] - c)
        big = _tf32(k_t)                              # k~ in two TF32 parts; v is exact
        s = torch.exp(c_last)[..., None] * s + big.transpose(-1, -2) @ vc \
            + _tf32(k_t - big).transpose(-1, -2) @ vc
    return torch.cat(ys, dim=2).to(r.dtype), s


# (B, H, T, dk, dv), whether s0 is given: the reference shapes, a ragged T over
# several chunks, and a decode step; the Pallas kernel takes no s0
TWO_PASS_CASES = [((2, 3, 50, 16, 16), False), ((2, 2, 33, 64, 64), False),
                  ((1, 4, 200, 64, 64), False), ((1, 4, 200, 64, 64), True),
                  ((4, 3, 1, 64, 64), True)]


@pytest.mark.parametrize("dims,s0,against", [
    (dims, s0, against) for dims, s0 in TWO_PASS_CASES
    for against in (("scan",) if s0 else ("pallas", "scan"))])
def test_two_pass_emulation_matches_jax(dims, s0, against):
    r, k, v, lw, u, s = _wkv_arrays(dims, seed=13, s0=s0)
    (jr, tr), (jk, tk), (jv, tv), (jl, tl) = (_pair(x, "bfloat16") for x in (r, k, v, lw))
    if against == "pallas":
        want_y, want_s = jax_wkv6(jr, jk, jv, jl, jnp.asarray(u))      # interpret mode
    else:
        want_y, want_s = jax_wkv_ref.wkv6_scan(jr, jk, jv, jnp.exp(jl.astype(jnp.float32)),
                                               jnp.asarray(u),
                                               None if s is None else jnp.asarray(s))
    got_y, got_s = _wkv6_two_pass_emulation(tr, tk, tv, tl, torch.from_numpy(u),
                                            None if s is None else torch.from_numpy(s))
    assert got_y.dtype == torch.bfloat16 and torch.isfinite(got_y.float()).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), **wkv_tol("bfloat16"))
    np.testing.assert_allclose(_np(got_s), _np(want_s), **STATE_TOL)


@pytest.mark.parametrize("against", ["pallas", "scan"])
def test_two_pass_emulation_extreme_decay_is_finite_and_close(against):
    """log_w = -20: every factored operand's exponent is <= 0, so nothing
    overflows; held at the bf16 bound."""
    r, k, v, _, _, _ = _wkv_arrays((1, 1, 64, 16, 16), seed=3)
    lw = np.full(r.shape, -20.0, np.float32)
    u = np.ones((1, 16), np.float32)
    (jr, tr), (jk, tk), (jv, tv), (jl, tl) = (_pair(x, "bfloat16") for x in (r, k, v, lw))
    if against == "pallas":
        want_y, _ = jax_wkv6(jr, jk, jv, jl, jnp.asarray(u))
    else:
        want_y, _ = jax_wkv_ref.wkv6_scan(jr, jk, jv, jnp.exp(jl.astype(jnp.float32)),
                                          jnp.asarray(u))
    got_y, got_s = _wkv6_two_pass_emulation(tr, tk, tv, tl, torch.from_numpy(u))
    assert torch.isfinite(got_y.float()).all() and torch.isfinite(got_s).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), **wkv_tol("bfloat16"))


# --- dispatch: CPU -> plain version, anything else -> kernel or raise -----------


def test_cpu_calls_never_count_a_launch():
    lru0, wkv0 = lru_kernel.rg_lru_fwd.launches, wkv_kernel.wkv6_fwd.launches
    a, b, _ = _lru_arrays((1, 5, 8), seed=5)
    got_y, _ = lru_ops.rg_lru(torch.from_numpy(a), torch.from_numpy(b))
    want_y, _ = lru_ref.rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got_y, want_y)
    r, k, v, lw, u, _ = (torch.from_numpy(x) if x is not None else None
                         for x in _wkv_arrays((1, 1, 5, 8, 8), seed=5))
    got_y, _ = wkv_ops.wkv6(r, k, v, lw, u)
    want_y, _ = wkv_ref.wkv6_scan(r, k, v, torch.exp(lw), u)
    assert torch.equal(got_y, want_y)
    assert (lru_kernel.rg_lru_fwd.launches, wkv_kernel.wkv6_fwd.launches) == (lru0, wkv0) == (0, 0)
    assert lru_kernel.rg_lru_fwd.launches_step == 0
    assert wkv_kernel.wkv6_fwd.launches_chunked == wkv_kernel.wkv6_fwd.launches_step == 0


def test_wrappers_reject_a_tensor_neither_on_cpu_nor_on_cuda():
    """No plain path off the CPU: a non-CUDA device raises, without a launch."""
    a = torch.rand(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        lru_kernel.rg_lru_fwd(a, a)
    r = torch.rand(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        wkv_kernel.wkv6_fwd(r, r, r, r, torch.rand(2, 8, device="meta"))


# --- blocks ---------------------------------------------------------------------


def _griffin(**kw):
    return dataclasses.replace(jax_configs.get("recurrentgemma-9b").scaled_down(),
                               dtype="float32", remat=False, **kw)


def _rwkv(**kw):
    return dataclasses.replace(jax_configs.get("rwkv6-3b").scaled_down(),
                               dtype="float32", remat=False, **kw)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), tree)


BLOCK_CASES = [("none", 9), ("state", 9), ("state", 1)]   # initial state, seq


@pytest.mark.parametrize("state,seq", BLOCK_CASES)
def test_rglru_block_matches_jax(state, seq):
    cfg = _griffin()
    jp = jax_recurrent.init_rglru(cfg, jax.random.PRNGKey(1), jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    js = None if state == "none" else _random_like(
        jax_recurrent.init_rglru_state(cfg, 2, jnp.float32), seed=7)
    want_y, want_s = jax_recurrent.rglru_block(cfg, jp, jnp.asarray(x),
                                               state=None if js is None else
                                               jax.tree.map(jnp.asarray, js))
    got_y, got_s = recurrent.rglru_block(port_cfg(cfg), _torch_tree(jp), torch.from_numpy(x),
                                         state=None if js is None else _torch_tree(js))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **BLOCK_TOL)
    for key in ("h", "conv_tail"):
        np.testing.assert_allclose(_np(got_s[key]), _np(want_s[key]), err_msg=key, **BLOCK_TOL)


@pytest.mark.parametrize("state,seq", BLOCK_CASES)
def test_rwkv6_block_and_cmix_match_jax(state, seq):
    cfg = _rwkv()
    jp = jax_recurrent.init_rwkv6(cfg, jax.random.PRNGKey(2), jnp.float32)
    jc = jax_recurrent.init_rwkv_cmix(cfg, jax.random.PRNGKey(3), jnp.float32)
    x = np.random.default_rng(8).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    js = jc_state = None
    if state == "state":
        js = _random_like(jax_recurrent.init_rwkv6_state(cfg, 2, jnp.float32), seed=9)
        jc_state = _random_like(np.zeros((2, cfg.d_model), np.float32), seed=10)
    want_y, want_s = jax_recurrent.rwkv6_block(
        cfg, jp, jnp.asarray(x), state=None if js is None else jax.tree.map(jnp.asarray, js))
    got_y, got_s = recurrent.rwkv6_block(port_cfg(cfg), _torch_tree(jp), torch.from_numpy(x),
                                         state=None if js is None else _torch_tree(js))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **BLOCK_TOL)
    for key in ("last", "wkv"):
        np.testing.assert_allclose(_np(got_s[key]), _np(want_s[key]), err_msg=key, **BLOCK_TOL)
    want_y, want_c = jax_recurrent.rwkv_cmix(
        cfg, jc, jnp.asarray(x), state=None if jc_state is None else jnp.asarray(jc_state))
    got_y, got_c = recurrent.rwkv_cmix(
        port_cfg(cfg), _torch_tree(jc), torch.from_numpy(x),
        state=None if jc_state is None else torch.from_numpy(jc_state))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(_np(got_c), _np(want_c), **BLOCK_TOL)


# --- models ---------------------------------------------------------------------


ARCH_CFGS = {"recurrentgemma-9b": _griffin, "rwkv6-3b": _rwkv}


def _tokens(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)
                                                ).astype(np.int32)


def test_scaled_down_griffin_has_both_segments():
    cfg = _griffin()
    assert cfg.num_layers == 4 and cfg.layer_kinds == ("rglru", "rglru", "local", "rglru")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_forward_matches_jax(arch, use_pallas):
    """The port against the JAX forward on its reference scans (use_pallas
    False) and on its Pallas kernels in interpret mode (True)."""
    cfg = ARCH_CFGS[arch](use_pallas=use_pallas)
    jp, model = both_params(cfg)
    tok = _tokens(cfg, 2, 24)
    want = jax_forward(cfg, jp, {"tokens": jnp.asarray(tok)}, mode="train").logits
    got = forward(model.cfg, model, {"tokens": torch.from_numpy(tok)}, mode="train").logits
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_prefill_decode_matches_jax(arch):
    cfg = ARCH_CFGS[arch]()
    jp, model = both_params(cfg)
    seq = 12
    tok = _tokens(cfg, 2, seq, seed=1)
    want_p, jc = jax_prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :seq - 3])},
                             max_seq=seq + 4)
    got_p, caches = prefill(model.cfg, model, {"tokens": torch.from_numpy(tok[:, :seq - 3])},
                            max_seq=seq + 4)
    np.testing.assert_allclose(_np(got_p), _np(want_p), atol=2e-3, rtol=2e-3)
    for t in range(seq - 3, seq):
        want_d, jc = jax_decode_step(cfg, jp, jnp.asarray(tok[:, t:t + 1]), jc)
        got_d, caches = decode_step(model.cfg, model, torch.from_numpy(tok[:, t:t + 1]), caches)
        np.testing.assert_allclose(_np(got_d), _np(want_d), atol=2e-3, rtol=2e-3,
                                   err_msg=f"decode step {t}")


def test_bf16_leaves_keep_the_reference_dtypes():
    """A bf16 model: the projections are bf16, while mu, decay_base, bonus_u,
    ln_* and lambda stay float32, as in the JAX parameters."""
    from repro.models.model import segments
    for arch in ARCH_CFGS:
        cfg = dataclasses.replace(ARCH_CFGS[arch](), dtype="bfloat16")
        jp, model = both_params(cfg)
        want = {(kind, name, key): a.dtype == jnp.float32
                for si, (kinds, _) in enumerate(segments(cfg))
                for pos, kind in enumerate(kinds)
                for name, sub in jp["decoder"][si][pos].items()
                for key, a in sub.items()}
        got = {(block.kind, name, key): t.dtype == torch.float32
               for block in model.blocks
               for name, sub in block.named_children()
               for key, t in sub.items()}
        assert got == want
        assert want[("rwkv6" if arch == "rwkv6-3b" else "rglru", "mix",
                     "bonus_u" if arch == "rwkv6-3b" else "lambda")]


@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_interop_round_trip_keeps_every_leaf(arch):
    """`params_from_jax` then `tree_from_model` gives back the JAX tree leaf by
    leaf, bit for bit, across both of recurrentgemma's segments and in bf16."""
    cfg = dataclasses.replace(ARCH_CFGS[arch](), dtype="bfloat16")
    jp, model = both_params(cfg)
    assert_trees_close(tree_from_model(model), jp, atol=0, rtol=0)


# --- on the card ----------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _lru_cuda_call(ta, tb, th):
    """B4 on the card, checking by the counters that the design of this T
    ran: the step kernel at T = 1, the ring above."""
    fn = lru_kernel.rg_lru_fwd
    before = (fn.launches, fn.launches_step)
    out = fn(ta, tb, th)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_step) == (before[0] + 1, before[1] + (ta.shape[1] == 1))
    return out


# (4, 3, 300): one ragged stage; D = 33: one-element copies in the ring (bf16
# rows are not 4-byte multiples) and one lane a thread in the step kernel
@pytest.mark.cuda
@pytest.mark.parametrize("shape", LRU_CASES + [(4, 3, 300), (2, 37, 33), (3, 1, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h0", [False, True])
def test_cuda_rg_lru_matches_plain(shape, dtype, h0):
    """Within the reference's bounds; in f32 the same bits (each lane's
    multiply and add rounded one by one, in order, as the plain version)."""
    _need_cuda()
    a, b, h = _lru_arrays(shape, seed=11, h0=h0)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda() for x in (a, b))
    th = None if h is None else torch.from_numpy(h).cuda()
    got_y, got_h = _lru_cuda_call(ta, tb, th)
    want_y, want_h = lru_ref.rg_lru_scan(ta, tb, th)
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y.cpu()), **lru_tol(dtype))
    np.testing.assert_allclose(_np(got_h.cpu()), _np(want_h.cpu()), **lru_tol(dtype))
    if dtype == "float32":
        assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rg_lru_ring_over_many_stages(dtype):
    """A ragged T over many stages of the ring (68 of 16 steps and 12) at the
    model's width, from h0: within the bounds, the plain version's bits in
    f32, and the same bits in two runs."""
    _need_cuda()
    a, b, h = _lru_arrays((2, 1100, 4096), seed=12, h0=True)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda() for x in (a, b))
    th = torch.from_numpy(h).cuda()
    got_y, got_h = _lru_cuda_call(ta, tb, th)
    again_y, again_h = _lru_cuda_call(ta, tb, th)
    assert torch.equal(got_y, again_y) and torch.equal(got_h, again_h)
    want_y, want_h = lru_ref.rg_lru_scan(ta, tb, th)
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y.cpu()), **lru_tol(dtype))
    np.testing.assert_allclose(_np(got_h.cpu()), _np(want_h.cpu()), **lru_tol(dtype))
    if dtype == "float32":
        assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", WKV_CASES + [(2, 3, 1, 64, 64), (1, 2, 130, 64, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s0", [False, True])
def test_cuda_wkv6_matches_plain(dims, dtype, s0):
    _need_cuda()
    r, k, v, lw, u, s = _wkv_arrays(dims, seed=12, s0=s0)
    tr, tk, tv, tl = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
                      for x in (r, k, v, lw))
    tu = torch.from_numpy(u).cuda()
    ts = None if s is None else torch.from_numpy(s).cuda()
    fn = wkv_kernel.wkv6_fwd
    before = (fn.launches, fn.launches_chunked, fn.launches_step)
    got_y, got_s, _ = fn(tr, tk, tv, tl, tu, ts)
    torch.cuda.synchronize()
    # T = 1 runs the step kernel, bf16 above it the two-pass design
    step, chunked = dims[2] == 1, dims[2] > 1 and dtype == "bfloat16"
    assert (fn.launches, fn.launches_chunked, fn.launches_step) == (
        before[0] + 1, before[1] + chunked, before[2] + step)
    want_y, want_s = wkv_ref.wkv6_scan(tr, tk, tv, torch.exp(tl.float()), tu, ts)
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y.cpu()), **wkv_tol(dtype))
    np.testing.assert_allclose(_np(got_s.cpu()), _np(want_s.cpu()), **STATE_TOL)


@pytest.mark.cuda
def test_cuda_wkv6_extreme_decay_is_finite_and_close():
    _need_cuda()
    r, k, v, _, _, _ = _wkv_arrays((1, 1, 64, 16, 16), seed=3)
    ts = [torch.from_numpy(x).cuda() for x in (r, k, v)]
    lw = torch.full(ts[0].shape, -20.0, device="cuda")
    u = torch.ones((1, 16), device="cuda")
    got_y, _, _ = wkv_kernel.wkv6_fwd(*ts, lw, u)
    want_y, _ = wkv_ref.wkv6_scan(*ts, torch.exp(lw), u)
    assert torch.isfinite(got_y).all()
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y.cpu()), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,s0", [((1, 4, 200, 64, 64), True), ((2, 2, 33, 64, 64), False),
                                     ((1, 2, 130, 64, 48), True), ((1, 2, 70, 7, 5), True)])
def test_cuda_wkv6_two_pass_matches_its_emulation(dims, s0):
    """B5's two-pass design (bf16, T > 1) against the plain emulation of its
    rounding, at ragged T, dk and dv that are not multiples of 8 included."""
    _need_cuda()
    r, k, v, lw, u, s = _wkv_arrays(dims, seed=14, s0=s0)
    tr, tk, tv, tl = (torch.from_numpy(x).bfloat16().cuda() for x in (r, k, v, lw))
    tu = torch.from_numpy(u).cuda()
    ts = None if s is None else torch.from_numpy(s).cuda()
    got_y, got_s, _ = wkv_kernel.wkv6_fwd(tr, tk, tv, tl, tu, ts)
    want_y, want_s = _wkv6_two_pass_emulation(*(t.cpu() for t in (tr, tk, tv, tl, tu)),
                                              None if ts is None else ts.cpu())
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y), **wkv_tol("bfloat16"))
    np.testing.assert_allclose(_np(got_s.cpu()), _np(want_s), **STATE_TOL)


@pytest.mark.cuda
def test_cuda_wkv6_two_pass_extreme_decay_and_bits():
    """log_w = -20 in bf16 through the two-pass design: finite and within the
    bf16 bound; and two runs give the same bits."""
    _need_cuda()
    r, k, v, _, _, _ = _wkv_arrays((1, 1, 64, 16, 16), seed=3)
    ts = [torch.from_numpy(x).bfloat16().cuda() for x in (r, k, v)]
    lw = torch.full(ts[0].shape, -20.0, device="cuda", dtype=torch.bfloat16)
    u = torch.ones((1, 16), device="cuda")
    got_y, got_s, _ = wkv_kernel.wkv6_fwd(*ts, lw, u)
    again_y, again_s, _ = wkv_kernel.wkv6_fwd(*ts, lw, u)
    want_y, _ = wkv_ref.wkv6_scan(*ts, torch.exp(lw.float()), u)
    assert torch.isfinite(got_y.float()).all()
    assert torch.equal(got_y, again_y) and torch.equal(got_s, again_s)
    np.testing.assert_allclose(_np(got_y.cpu()), _np(want_y.cpu()), **wkv_tol("bfloat16"))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    r = torch.rand(1, 2, 4, 80, device="cuda")
    with pytest.raises(ValueError, match="dk 80"):
        wkv_kernel.wkv6_fwd(r, r, r, -r, torch.rand(2, 80, device="cuda"))
    a = torch.rand(1, 8, 4, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lru_kernel.rg_lru_fwd(a, a)
    a = torch.rand(1, 4, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        lru_kernel.rg_lru_fwd(a, a)

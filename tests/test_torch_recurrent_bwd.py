"""Port parity: the backward of the recurrences (RG-LRU, kernel B4'; RWKV-6,
kernel B5') vs the JAX package.

The JAX ops have no backward kernel: their `custom_vjp` differentiates the
reference scan.  Here the same numpy inputs and cotangents (from a seed, on
both outputs: y and the final state) go through `jax.vjp` of the JAX op (its
Pallas forward in interpret mode) or of its reference scan (which takes an
initial state, the op does not), and through the port's plain backward
(`ref.rg_lru_scan_bwd`, `ref.wkv6_scan_bwd`) and the op's autograd.  Bounds:
f32 1e-5 (B4) and 1e-4 (B5), as the forward tests' gradient checks; bf16
2e-2 + 2e-2|want|.  On the card, B4' and B5' are held to their plain
versions (`cuda` marker; these cases need no JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: there only the `cuda` cases run (-m cuda)
    import jax
    import jax.numpy as jnp

    from repro.kernels.rg_lru import ref as jax_lru_ref
    from repro.kernels.rg_lru.ops import rg_lru as jax_rg_lru
    from repro.kernels.wkv6 import ref as jax_wkv_ref
    from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
except ModuleNotFoundError:
    jax = None

from repro_torch.kernels.rg_lru import kernel as lru_kernel  # noqa: E402
from repro_torch.kernels.rg_lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ref as lru_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402

DTYPES = ("float32", "bfloat16")
LRU_CASES = [(2, 100, 48), (1, 256, 128), (3, 17, 8), (1, 1, 16)]   # B, T, D
WKV_CASES = [(2, 3, 50, 16, 16), (1, 2, 64, 32, 32), (1, 1, 7, 8, 8),
             (2, 2, 33, 64, 64)]                                     # B, H, T, dk, dv
LRU_NAMES = ("da", "db", "dh0")
WKV_NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")


def tol(dtype, f32):
    return ({"atol": 2e-2, "rtol": 2e-2} if dtype == "bfloat16"
            else {"atol": f32, "rtol": f32})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16(x):
    """f32 numpy values rounded to bf16 (nearest even), back in f32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _lru_arrays(shape, seed, dtype, h0=False):
    """a, b in `dtype`'s values (as f32 numpy), h0 f32 or None, and the
    cotangents gy (y's dtype) and gh (f32) of both outputs."""
    rng = np.random.default_rng(seed)
    bsz, _, d = shape
    a = rng.uniform(0.2, 0.99, shape).astype(np.float32)
    b, gy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    h = rng.standard_normal((bsz, d)).astype(np.float32) if h0 else None
    gh = rng.standard_normal((bsz, d)).astype(np.float32)
    if dtype == "bfloat16":
        a, b, gy = _bf16(a), _bf16(b), _bf16(gy)
    return a, b, h, gy, gh


def _wkv_arrays(dims, seed, dtype, s0=False, log_w=None):
    """r, k, v, log_w in `dtype`'s values, u f32, s0 f32 or None, and the
    cotangents gy (y's dtype) and gs (f32)."""
    bsz, heads, steps, dk, dv = dims
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((bsz, heads, steps, dk)).astype(np.float32) for _ in range(2))
    v, gy = (rng.standard_normal((bsz, heads, steps, dv)).astype(np.float32) for _ in range(2))
    lw = -np.exp(rng.standard_normal((bsz, heads, steps, dk))).astype(np.float32)
    if log_w is not None:
        lw = np.full_like(lw, log_w)
    u = rng.standard_normal((heads, dk)).astype(np.float32)
    s = rng.standard_normal((bsz, heads, dk, dv)).astype(np.float32) if s0 else None
    gs = rng.standard_normal((bsz, heads, dk, dv)).astype(np.float32)
    if dtype == "bfloat16":
        r, k, v, lw, gy = (_bf16(x) for x in (r, k, v, lw, gy))
    return r, k, v, lw, u, s, gy, gs


def _t(x, dtype="float32"):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    """A JAX array holding a copy of x (not a view of the numpy memory that
    the port's tensors share)."""
    return None if x is None else jnp.array(x, getattr(jnp, dtype), copy=True)


def _vjp(fn, primals, cotangents):
    """jax.vjp of fn at primals, applied to cotangents, as numpy arrays, the
    forward and the VJP run to completion."""
    out, vjp = jax.vjp(fn, *primals)
    grads = vjp(cotangents)
    jax.block_until_ready((out, grads))
    return [np.asarray(g) for g in grads]


def _op_grads(op, inputs, outputs_cot):
    """The op's gradients by autograd, with cotangents on both outputs."""
    leaves = [t.clone().requires_grad_() if t is not None else None for t in inputs]
    y, s = op(*leaves)
    gy, gs = outputs_cot
    grads = torch.autograd.grad((y.float() * gy.float()).sum() + (s * gs).sum(),
                                [t for t in leaves if t is not None])
    it = iter(grads)
    return [next(it) if t is not None else None for t in leaves]


def _assert_close(got, want, names, bounds):
    for name, g, w in zip(names, got, want, strict=True):
        if w is None:
            continue
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **bounds)


# --- B4': the plain backward and the op's gradient vs JAX --------------------------


@pytest.mark.parametrize("shape", LRU_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rg_lru_bwd_matches_jax_op_vjp(shape, dtype):
    """Against jax.vjp of the JAX op (Pallas forward in interpret mode, its
    reference scan differentiated), cotangents on y and h_last."""
    a, b, _, gy, gh = _lru_arrays(shape, seed=20, dtype=dtype)
    ta, tb, tgy, tgh = _t(a, dtype), _t(b, dtype), _t(gy, dtype), _t(gh)
    want = (*_vjp(lambda a_, b_: jax_rg_lru(a_, b_), (_j(a, dtype), _j(b, dtype)),
                  (_j(gy, dtype), _j(gh))), None)
    got = lru_ref.rg_lru_scan_bwd(ta, tb, None, tgy, tgh)
    got_op = _op_grads(lru_ops.rg_lru, (ta, tb, None), (tgy, tgh))
    assert got[0].dtype == got[1].dtype == ta.dtype and got[2].dtype == torch.float32
    _assert_close(got, want, LRU_NAMES, tol(dtype, 1e-5))
    _assert_close(got_op, want, LRU_NAMES, tol(dtype, 1e-5))


# (2, 1100, 48): a T over many 8-step groups of B4', not a multiple of one
@pytest.mark.parametrize("shape", [(2, 100, 48), (3, 17, 8), (4, 1, 64), (2, 1100, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rg_lru_bwd_from_h0_matches_jax_scan_vjp(shape, dtype):
    """From a nonzero h0, whose gradient is returned too: against jax.vjp of
    the reference scan (the JAX op takes no initial state)."""
    a, b, h0, gy, gh = _lru_arrays(shape, seed=21, dtype=dtype, h0=True)
    ins = (_t(a, dtype), _t(b, dtype), _t(h0))
    want = _vjp(jax_lru_ref.rg_lru_scan, (_j(a, dtype), _j(b, dtype), _j(h0)),
                (_j(gy, dtype), _j(gh)))
    got = lru_ref.rg_lru_scan_bwd(*ins, _t(gy, dtype), _t(gh))
    got_op = _op_grads(lru_ops.rg_lru, ins, (_t(gy, dtype), _t(gh)))
    assert got[2].dtype == torch.float32
    _assert_close(got, want, LRU_NAMES, tol(dtype, 1e-5))
    _assert_close(got_op, want, LRU_NAMES, tol(dtype, 1e-5))


def test_rg_lru_bwd_near_total_forgetting_matches_jax():
    """a = e^-20 every step: each h_t is b_t to f32 precision, and the
    gradients still equal JAX's."""
    a, b, h0, gy, gh = _lru_arrays((2, 64, 16), seed=22, dtype="float32", h0=True)
    a = np.full_like(a, np.exp(-20.0))
    want = _vjp(jax_lru_ref.rg_lru_scan, (_j(a), _j(b), _j(h0)), (_j(gy), _j(gh)))
    got = lru_ref.rg_lru_scan_bwd(_t(a), _t(b), _t(h0), _t(gy), _t(gh))
    assert all(np.isfinite(_np(g)).all() for g in got)
    _assert_close(got, want, LRU_NAMES, tol("float32", 1e-5))


@pytest.mark.parametrize("shape", [(2, 100, 48), (2, 1100, 48)])
def test_rg_lru_bwd_from_rounded_h_stays_within_bf16_bound(shape):
    """B4' reads h_{t-1} from the forward's y, which in bf16 is h rounded.  An
    emulation of that (the plain reverse loop with h_{t-1} rounded to bf16)
    stays within the bf16 bound of the plain backward from f32 h."""
    a, b, h0, gy, gh = _lru_arrays(shape, seed=23, dtype="bfloat16", h0=True)
    ta, tb, th0, tgy, tgh = _t(a, "bfloat16"), _t(b, "bfloat16"), _t(h0), \
        _t(gy, "bfloat16"), _t(gh)
    y, _ = lru_ref.rg_lru_scan(ta, tb, th0)                      # y: h rounded to bf16
    h_prev = torch.cat([th0[:, None], y[:, :-1].float()], dim=1)
    dh, da, db = tgh.clone(), torch.empty(a.shape), torch.empty(a.shape)
    for t in range(a.shape[1] - 1, -1, -1):
        dh = dh + tgy[:, t].float()
        db[:, t], da[:, t] = dh, dh * h_prev[:, t]
        dh = ta[:, t].float() * dh
    want = lru_ref.rg_lru_scan_bwd(ta, tb, th0, tgy, tgh)
    _assert_close((da.bfloat16(), db.bfloat16(), dh), want, LRU_NAMES, tol("bfloat16", None))


# --- B5': the plain backward and the op's gradient vs JAX --------------------------


def _jax_log_w(lw, dtype):
    """log_w for the JAX op: its backward takes exp(log_w) in log_w's dtype,
    which in bf16 rounds the decay w itself to bf16; the port's forward and
    backward take it in f32 from the bf16 values.  So the JAX op gets the same
    bf16 values as f32, and both sides differentiate the same function
    (test_wkv6_bwd_bf16_differs_from_the_jax_op_only_by_its_rounded_decay
    holds the port to the JAX op given bf16 log_w)."""
    return _j(lw, "float32")


@pytest.mark.parametrize("dims", WKV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_bwd_matches_jax_op_vjp(dims, dtype):
    """Against jax.vjp of the JAX op (Pallas forward in interpret mode, its
    reference scan differentiated), cotangents on y and s_last; u in f32,
    as the model keeps it."""
    r, k, v, lw, u, _, gy, gs = _wkv_arrays(dims, seed=30, dtype=dtype)
    ins = (*(_t(x, dtype) for x in (r, k, v, lw)), _t(u), None)
    want = (*_vjp(lambda *xs: jax_wkv6(*xs),
                  (*(_j(x, dtype) for x in (r, k, v)), _jax_log_w(lw, dtype), _j(u)),
                  (_j(gy, dtype), _j(gs))), None)
    got = wkv_ref.wkv6_scan_bwd(*ins, _t(gy, dtype), _t(gs))
    got_op = _op_grads(wkv_ops.wkv6, ins, (_t(gy, dtype), _t(gs)))
    assert [g.dtype for g in got[:4]] == [ins[0].dtype] * 4 and got[4].dtype == torch.float32
    _assert_close(got, want, WKV_NAMES, tol(dtype, 1e-4))
    _assert_close(got_op, want, WKV_NAMES, tol(dtype, 1e-4))


@pytest.mark.parametrize("dims", WKV_CASES)
def test_wkv6_bwd_bf16_differs_from_the_jax_op_only_by_its_rounded_decay(dims):
    """The JAX op given bf16 log_w as it is: its backward takes w =
    exp(log_w) rounded to bf16.  The port's plain backward given the log of
    that rounded w (in f32, so that its exp gives the same w) equals it
    within the bf16 bound, dlog_w included, which the JAX op returns as
    bf16(bf16(dL/dw) w).  Without the rounded w the port lies outside the
    bound at some elements of two of these shapes
    (`tests/recurrent_bwd_readings.py`)."""
    r, k, v, lw, u, _, gy, gs = _wkv_arrays(dims, seed=30, dtype="bfloat16")
    w_bf16 = np.asarray(jnp.exp(_j(lw, "bfloat16")), np.float32)    # JAX's rounded decay
    lw_rounded = np.log(w_bf16)
    assert np.array_equal(_bf16(torch.exp(_t(lw_rounded)).numpy()), w_bf16)
    ins = (*(_t(x, "bfloat16") for x in (r, k, v)), _t(lw_rounded), _t(u), None)
    want = (*_vjp(lambda *xs: jax_wkv6(*xs),
                  (*(_j(x, "bfloat16") for x in (r, k, v, lw)), _j(u)),
                  (_j(gy, "bfloat16"), _j(gs))), None)
    got = wkv_ref.wkv6_scan_bwd(*ins, _t(gy, "bfloat16"), _t(gs))
    assert want[3].dtype == jnp.bfloat16
    _assert_close(got, want, WKV_NAMES, tol("bfloat16", None))


@pytest.mark.parametrize("dims", [(2, 3, 50, 16, 16), (2, 2, 33, 64, 64), (4, 3, 1, 64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_bwd_from_s0_matches_jax_scan_vjp(dims, dtype):
    """From a nonzero s0, whose gradient is returned too: against jax.vjp of
    the reference scan on exp(log_w) in f32 (the JAX op takes no state)."""
    r, k, v, lw, u, s0, gy, gs = _wkv_arrays(dims, seed=31, dtype=dtype, s0=True)

    def scan(r_, k_, v_, lw_, u_, s0_):
        return jax_wkv_ref.wkv6_scan(r_, k_, v_, jnp.exp(lw_.astype(jnp.float32)), u_, s0_)
    ins = (*(_t(x, dtype) for x in (r, k, v, lw)), _t(u), _t(s0))
    want = _vjp(scan, (*(_j(x, dtype) for x in (r, k, v, lw)), _j(u), _j(s0)),
                (_j(gy, dtype), _j(gs)))
    got = wkv_ref.wkv6_scan_bwd(*ins, _t(gy, dtype), _t(gs))
    got_op = _op_grads(wkv_ops.wkv6, ins, (_t(gy, dtype), _t(gs)))
    _assert_close(got, want, WKV_NAMES, tol(dtype, 1e-4))
    _assert_close(got_op, want, WKV_NAMES, tol(dtype, 1e-4))


@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_bwd_extreme_decay_matches_jax(dtype):
    """log_w = -20 (near-total forgetting each step), as the forward's
    test_plain_wkv6_extreme_decay_matches_jax: finite, and equal to JAX's."""
    r, k, v, lw, _, _, gy, gs = _wkv_arrays((1, 1, 64, 16, 16), seed=32, dtype=dtype,
                                            log_w=-20.0)
    u = np.ones((1, 16), np.float32)
    ins = (*(_t(x, dtype) for x in (r, k, v, lw)), _t(u), None)
    want = (*_vjp(lambda *xs: jax_wkv6(*xs),
                  (*(_j(x, dtype) for x in (r, k, v)), _jax_log_w(lw, dtype), _j(u)),
                  (_j(gy, dtype), _j(gs))), None)
    got = wkv_ref.wkv6_scan_bwd(*ins, _t(gy, dtype), _t(gs))
    assert all(torch.isfinite(g.float()).all() for g in got)
    _assert_close(got, want, WKV_NAMES, tol(dtype, 1e-4))


@pytest.mark.parametrize("dims", WKV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_plain_bwd_gives_the_same_bits_around_jax_work(dims, dtype):
    """The plain backward (the port's CPU training path, and what B5' is held
    to on the card) and the op's gradient give the same bits before, during
    and after `jax.vjp` of the JAX op in the same process: the JAX side is
    given zero-copy views of the numpy arrays that the port's tensors share,
    and is not waited for until the port's second run is done.  The inputs
    are unchanged afterwards."""
    r, k, v, lw, u, _, gy, gs = _wkv_arrays(dims, seed=30, dtype=dtype)
    ins = (*(_t(x, dtype) for x in (r, k, v, lw)), _t(u), None)
    cot = (_t(gy, dtype), _t(gs))
    runs = [(wkv_ref.wkv6_scan_bwd(*ins, *cot), _op_grads(wkv_ops.wkv6, ins, cot))]
    out, vjp = jax.vjp(lambda *xs: jax_wkv6(*xs),
                       *(jnp.asarray(x, dtype) for x in (r, k, v)), jnp.asarray(lw),
                       jnp.asarray(u))
    grads = vjp((jnp.asarray(gy, dtype), jnp.asarray(gs)))
    runs.append((wkv_ref.wkv6_scan_bwd(*ins, *cot), _op_grads(wkv_ops.wkv6, ins, cot)))
    jax.block_until_ready((out, grads))
    runs.append((wkv_ref.wkv6_scan_bwd(*ins, *cot), _op_grads(wkv_ops.wkv6, ins, cot)))
    for plain, op in runs[1:]:
        for name, x, y in zip(WKV_NAMES, plain, runs[0][0], strict=True):
            assert torch.equal(x, y), name
        for name, x, y in zip(WKV_NAMES, op, runs[0][1], strict=True):
            assert (x is None and y is None) or torch.equal(x, y), name
    fresh = _wkv_arrays(dims, seed=30, dtype=dtype)
    for x, y in zip((r, k, v, lw, u, gy, gs), fresh[:5] + fresh[6:], strict=True):
        assert np.array_equal(x, y)


def test_cpu_backward_counts_no_launch():
    """On the CPU the op's backward is the plain version, not a launch."""
    before = (lru_kernel.rg_lru_bwd.launches, wkv_kernel.wkv6_bwd.launches,
              wkv_kernel.wkv6_bwd.launches_entry)
    a = torch.rand(1, 5, 8, requires_grad=True)
    lru_ops.rg_lru(a, a * 0.5)[0].sum().backward()
    r = torch.rand(1, 1, 5, 8, requires_grad=True)
    wkv_ops.wkv6(r, r, r, -r, torch.rand(1, 8))[0].sum().backward()
    assert a.grad is not None and r.grad is not None
    assert before == (lru_kernel.rg_lru_bwd.launches, wkv_kernel.wkv6_bwd.launches,
                      wkv_kernel.wkv6_bwd.launches_entry) == (0, 0, 0)


def test_backward_wrappers_reject_a_tensor_neither_on_cpu_nor_on_cuda():
    a = torch.rand(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        lru_kernel.rg_lru_bwd(a, a, None, a, a)
    r = torch.rand(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        wkv_kernel.wkv6_bwd(r, r, r, r, torch.rand(2, 8, device="meta"), None, r)


# --- on the card ----------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _cuda(x, dtype="float32"):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, dtype)).cuda()


def _card_bounds(dtype, f32):
    return {"atol": 2e-2, "rtol": 2e-2} if dtype == "bfloat16" else {"atol": f32, "rtol": f32}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LRU_CASES + [(2, 1100, 48), (2, 37, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h0", [False, True])
def test_cuda_rg_lru_bwd_matches_plain(shape, dtype, h0):
    """B4' against its plain version; in f32 the same bits (one add and two
    multiplies a step, each rounded, in the plain version's order), and two
    runs give the same bits in both dtypes."""
    _need_cuda()
    a, b, h, gy, gh = _lru_arrays(shape, seed=40, dtype=dtype, h0=h0)
    ta, tb, tgy = (_cuda(x, dtype) for x in (a, b, gy))
    th, tgh = _cuda(h), _cuda(gh)
    y, _ = lru_kernel.rg_lru_fwd(ta, tb, th)
    before = lru_kernel.rg_lru_bwd.launches
    got = lru_kernel.rg_lru_bwd(ta, tb, th, y, tgy, tgh)
    again = lru_kernel.rg_lru_bwd(ta, tb, th, y, tgy, tgh)
    torch.cuda.synchronize()
    assert lru_kernel.rg_lru_bwd.launches == before + 2
    assert all(torch.equal(x, z) for x, z in zip(got, again, strict=True))
    want = lru_ref.rg_lru_scan_bwd(ta, tb, th, tgy, tgh)
    for name, g, w in zip(LRU_NAMES, got, want, strict=True):
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), err_msg=name,
                                   **_card_bounds(dtype, 1e-5))
    if dtype == "float32":
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", WKV_CASES + [(1, 4, 200, 64, 64), (1, 2, 130, 64, 48),
                                              (1, 2, 70, 7, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s0", [False, True])
def test_cuda_wkv6_bwd_matches_plain(dims, dtype, s0):
    """B5' against its plain version, from the forward's chunk-entry states
    (bf16, T > 1) or its own (f32, T = 1), and two runs give the same bits."""
    _need_cuda()
    r, k, v, lw, u, s, gy, gs = _wkv_arrays(dims, seed=41, dtype=dtype, s0=s0)
    ins = (*(_cuda(x, dtype) for x in (r, k, v, lw)), _cuda(u), _cuda(s))
    tgy, tgs = _cuda(gy, dtype), _cuda(gs)
    _, _, ws = wkv_kernel.wkv6_fwd(*ins)
    assert (ws is not None) == (dtype == "bfloat16" and dims[2] > 1)
    fn = wkv_kernel.wkv6_bwd
    before = (fn.launches, fn.launches_entry)
    got = fn(*ins, tgy, tgs, ws)
    again = fn(*ins, tgy, tgs, ws)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_entry) == (before[0] + 2, before[1] + 2 * (ws is None))
    assert all(torch.equal(x, z) for x, z in zip(got, again, strict=True))
    want = wkv_ref.wkv6_scan_bwd(*ins, tgy, tgs)
    for name, g, w in zip(WKV_NAMES, got, want, strict=True):
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), err_msg=name,
                                   **_card_bounds(dtype, 1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_ops_train_on_the_card(dtype):
    """The ops' gradients on the card (B4', B5') equal the plain backward's."""
    _need_cuda()
    a, b, _, gy, _ = _lru_arrays((2, 70, 40), seed=42, dtype=dtype)
    ta, tb = (_cuda(x, dtype).requires_grad_() for x in (a, b))
    (lru_ops.rg_lru(ta, tb)[0].float() * _cuda(gy)).sum().backward()
    want = lru_ref.rg_lru_scan_bwd(ta.detach(), tb.detach(), None, _cuda(gy, dtype))
    for g, w in zip((ta.grad, tb.grad), want[:2], strict=True):
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), **_card_bounds(dtype, 1e-5))
    r, k, v, lw, u, _, gy, _ = _wkv_arrays((2, 2, 90, 64, 64), seed=43, dtype=dtype)
    ins = [_cuda(x, dtype).requires_grad_() for x in (r, k, v, lw)] + \
        [_cuda(u).requires_grad_()]
    (wkv_ops.wkv6(*ins)[0].float() * _cuda(gy)).sum().backward()
    want = wkv_ref.wkv6_scan_bwd(*(x.detach() for x in ins), None, _cuda(gy, dtype))
    for g, w in zip([x.grad for x in ins], want[:5], strict=True):
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), **_card_bounds(dtype, 1e-4))

"""Port parity: the backward of the recurrences (RG-LRU, kernel B4'; RWKV-6,
kernel B5') vs the JAX package.

The JAX ops have no backward kernel: their `custom_vjp` differentiates the
reference scan.  Here the same numpy inputs and cotangents (from a seed, on
both outputs: y and the final state) go through `jax.vjp` of the JAX op (its
Pallas forward in interpret mode) or of its reference scan (which takes an
initial state, the op does not), and through the port's plain backward
(`ref.rg_lru_scan_bwd`, `ref.wkv6_scan_bwd`) and the op's autograd.  Bounds:
f32 1e-5 (B4) and 1e-4 (B5), as the forward tests' gradient checks; bf16
2e-2 + 2e-2|want|.  An emulation of B5''s bf16 design (its rounding
included) is held to the same JAX gradients, its identities unrounded in
float64 to the plain reverse loop.  On the card, B4' and B5' are held to
their plain versions (`cuda` marker; these cases need no JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

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


# (2, 1100, 48): a T over many 16-step stages of B4''s ring, not a multiple of one
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
              wkv_kernel.wkv6_bwd.launches_chunked, wkv_kernel.wkv6_bwd.launches_entry)
    a = torch.rand(1, 5, 8, requires_grad=True)
    lru_ops.rg_lru(a, a * 0.5)[0].sum().backward()
    r = torch.rand(1, 1, 5, 8, requires_grad=True)
    wkv_ops.wkv6(r, r, r, -r, torch.rand(1, 8))[0].sum().backward()
    rb = torch.rand(1, 1, 5, 8, dtype=torch.bfloat16, requires_grad=True)
    wkv_ops.wkv6(rb, rb, rb, -rb, torch.rand(1, 8))[0].float().sum().backward()
    assert a.grad is not None and r.grad is not None and rb.grad is not None
    assert before == (lru_kernel.rg_lru_bwd.launches, wkv_kernel.wkv6_bwd.launches,
                      wkv_kernel.wkv6_bwd.launches_chunked,
                      wkv_kernel.wkv6_bwd.launches_entry) == (0, 0, 0, 0)


def test_backward_wrappers_reject_a_tensor_neither_on_cpu_nor_on_cuda():
    a = torch.rand(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        lru_kernel.rg_lru_bwd(a, a, None, a, a)
    r = torch.rand(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        wkv_kernel.wkv6_bwd(r, r, r, r, torch.rand(2, 8, device="meta"), None, r)


# --- B5''s chunked design (bf16), emulated -----------------------------------------


def _tf32(x):
    """f32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """f32 truncated to TF32 (the low 13 mantissa bits cleared), as the
    tensor core reads an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _wkv6_chunked_bwd_emulation(r, k, v, log_w, u, s0, gy, gs_last, exact=False, chunk=64,
                                sub=16):
    """What B5''s bf16 design computes, in plain PyTorch, chunk by chunk (each
    padded to 64 steps with zeros and log_w = 0, as the kernel's tiles are),
    with c the chunk-local cumulative sum of log_w (c_{-1} = 0), S_in the
    state entering a chunk and G_out the gradient of the state leaving it:
      the forward's chunk-entry states (its state pass: k~ in two TF32 parts),
        stored rounded to TF32;
      pass 1, chunks last to first: G_out stored rounded to TF32, then
        G_in = e^{c_L} G_out + (r e^{c_{t-1}})^T gy, r e^{c_{t-1}} in two TF32 parts;
      pass 2, per chunk, rows in sub-blocks of 16 starting at s, dA = gy v^T:
        dr: e^{c_{t-1}} (gy S_in^T) + e^{c_{t-1} - c_{s-1}} (dA[:, <s] k~) with
          k~_j = k_j e^{c_{s-1} - c_j}; in the sub-block's lower-left 8 x 8
          quarter the same against step s + 7; per element in its two
          diagonal 8 x 8 quarters;
        dk: e^{c_L - c_j} (v G_out^T) apart (it feeds dlog_w), and
          e^{c_{s+15} - c_j} dA[>s+15, :]^T r^ with r^_t = r_t e^{c_{t-1} - c_{s+15}};
          the quarter against s + 7; the diagonal quarters per element;
        dv: (k e^{c_L - c}) G_out + A^T gy over t past the sub-block (A from
          operands against s + 15) and inside it (the quarter against s + 7,
          the diagonal quarters per element), the bonus term in f32 apart;
        dlog_w = e^{c_L} rowsum(G_out S_in) + sum_j k_j dk_j^inter
          + sum_{tau > t} r dr' - sum_{j >= t} k dk' (dr', dk' without the
          bonus), taken as X + sum_{tau > t} Z_tau - Q_t with P = r dr',
          Q = k dk', Z = P - Q.
    The products of dr's and dk's intra-chunk terms, which dlog_w's reverse
    sums take apart, take their decayed operand (k~, r^) in two TF32 parts
    (the truncated value and the rest, truncated in its turn) and dA in one
    (rounded alike in both, its rounding cancels there), and so does the
    gradient-state pass's r e^{c_{t-1}}; the other products round their
    derived operands to TF32 once, to nearest; bf16 operands, S_in and
    G_out are TF32 values already.  With `exact` nothing is rounded and
    everything runs in float64: the identities alone.
    Returns (dr, dk, dv, dlog_w, du, ds0), unrounded to the output dtype."""
    dt = torch.float64 if exact else torch.float32
    rnd = (lambda x: x) if exact else _tf32
    trunc = (lambda x: x) if exact else _tf32_trunc

    def mm2(a, b):  # b in two truncated TF32 parts, a in one
        if exact:
            return a @ b
        bb = trunc(b)
        return _tf32(a) @ bb + _tf32(a) @ trunc(b - bb)

    def mm3(a, b):  # both operands in two parts, the small x small product dropped
        if exact:
            return a @ b
        ab, bb = _tf32(a), _tf32(b)
        return ab @ bb + ab @ _tf32(b - bb) + _tf32(a - ab) @ bb

    bsz, heads, steps, dk = r.shape
    dv = v.shape[-1]
    n_chunks = -(-steps // chunk)
    pad = n_chunks * chunk - steps
    rf, kf, vf, gf, lw = (torch.nn.functional.pad(x.to(dt), (0, 0, 0, pad))
                          for x in (r, k, v, gy, log_w))
    uf = u.to(dt)[None, :, None, :]

    def part(x, i):
        return x[:, :, i * chunk:(i + 1) * chunk]

    cs = [torch.cumsum(part(lw, i), dim=2) for i in range(n_chunks)]
    s = torch.zeros(bsz, heads, dk, dv, dtype=dt) if s0 is None else s0.to(dt)
    s_in = []
    for i in range(n_chunks):                                    # the forward's states
        s_in.append(rnd(s))
        c_l = cs[i][:, :, -1]
        kt = part(kf, i) * torch.exp(c_l[:, :, None] - cs[i])
        s = torch.exp(c_l)[..., None] * s + mm3(kt.transpose(-1, -2), part(vf, i))
    g = torch.zeros(bsz, heads, dk, dv, dtype=dt) if gs_last is None else gs_last.to(dt)
    g_out = [None] * n_chunks
    for i in reversed(range(n_chunks)):                          # pass 1
        g_out[i] = rnd(g)
        c = cs[i]
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], 2)
        rt = part(rf, i) * torch.exp(cprev)
        big = trunc(rt)                                         # gy is exact in TF32
        g = torch.exp(c[:, :, -1])[..., None] * g + big.transpose(-1, -2) @ part(gf, i) \
            + trunc(rt - big).transpose(-1, -2) @ part(gf, i)
    ds0 = g
    outs = {name: [] for name in ("dr", "dk", "dv", "dlw")}
    du = torch.zeros(heads, dk, dtype=dt)
    strict = torch.ones(8, 8, dtype=torch.bool).tril(-1)[:, :, None]
    for i in range(n_chunks):                                    # pass 2
        rc, kc, vc, gc, c = part(rf, i), part(kf, i), part(vf, i), part(gf, i), cs[i]
        c_l = c[:, :, -1:]
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], 2)
        sin, gout = s_in[i], g_out[i]
        da = gc @ vc.transpose(-1, -2)                           # dA[t, j] = gy_t . v_j
        vg = torch.diagonal(da, dim1=-2, dim2=-1)[..., None]     # v_t . gy_t
        dr, dki, dko = (torch.zeros(bsz, heads, chunk, dk, dtype=dt) for _ in range(3))
        dvv = torch.zeros(bsz, heads, chunk, dv, dtype=dt)
        for s_ in range(0, chunk, sub):
            blk, lo, hi = slice(s_, s_ + sub), slice(s_, s_ + 8), slice(s_ + 8, s_ + sub)
            c_s1 = cprev[:, :, s_:s_ + 1]                        # c_{s-1}
            c_7, c_15 = c[:, :, s_ + 7:s_ + 8], c[:, :, s_ + 15:s_ + 16]
            dr[:, :, blk] = torch.exp(cprev[:, :, blk]) * (gc[:, :, blk] @ sin.transpose(-1, -2))
            if s_ > 0:
                dr[:, :, blk] += torch.exp(cprev[:, :, blk] - c_s1) * mm2(
                    da[:, :, blk, :s_], kc[:, :, :s_] * torch.exp(c_s1 - c[:, :, :s_]))
            dr[:, :, hi] += torch.exp(cprev[:, :, hi] - c_7) * mm2(
                da[:, :, hi, lo], kc[:, :, lo] * torch.exp(c_7 - c[:, :, lo]))
            dki[:, :, blk] = torch.exp(c_l - c[:, :, blk]) * (vc[:, :, blk] @ gout.transpose(-1, -2))
            if s_ + sub < chunk:
                later = slice(s_ + sub, chunk)
                r_hat = rc[:, :, later] * torch.exp(cprev[:, :, later] - c_15)
                dko[:, :, blk] = torch.exp(c_15 - c[:, :, blk]) * mm2(
                    da[:, :, later, blk].transpose(-1, -2), r_hat)
                at = rnd(kc[:, :, blk] * torch.exp(c_15 - c[:, :, blk])) @ \
                    rnd(r_hat).transpose(-1, -2)                 # A^T[j, t], t past the block
                dvv[:, :, blk] += rnd(at) @ gc[:, :, later]
            dko[:, :, lo] += torch.exp(c_7 - c[:, :, lo]) * mm2(
                da[:, :, hi, lo].transpose(-1, -2), rc[:, :, hi] * torch.exp(cprev[:, :, hi] - c_7))
            a_blk = torch.zeros(bsz, heads, sub, sub, dtype=dt)  # A[t, j] inside the block
            for q0 in (s_, s_ + 8):                              # the diagonal quarters
                qs = slice(q0, q0 + 8)
                e = torch.exp(torch.where(strict, cprev[:, :, qs, None, :] - c[:, :, None, qs, :],
                                          torch.tensor(float("-inf"), dtype=dt)))  # [t, j, d]
                da_q = da[:, :, qs, qs][..., None]
                dr[:, :, qs] += (da_q * kc[:, :, None, qs] * e).sum(3)
                dko[:, :, qs] += (da_q * rc[:, :, qs, None] * e).sum(2)
                a_blk[:, :, q0 - s_:q0 - s_ + 8, q0 - s_:q0 - s_ + 8] = \
                    (rc[:, :, qs, None] * kc[:, :, None, qs] * e).sum(-1)
            a_blk[:, :, 8:, :8] = rnd(rc[:, :, hi] * torch.exp(cprev[:, :, hi] - c_7)) @ \
                rnd(kc[:, :, lo] * torch.exp(c_7 - c[:, :, lo])).transpose(-1, -2)
            dvv[:, :, blk] += rnd(a_blk).transpose(-1, -2) @ gc[:, :, blk]
            dvv[:, :, blk] += rnd(kc[:, :, blk] * torch.exp(c_l - c[:, :, blk])) @ gout
            dvv[:, :, blk] += (rc[:, :, blk] * uf * kc[:, :, blk]).sum(-1, keepdim=True) \
                * gc[:, :, blk]                                  # the bonus, in f32
        dkp = dko + dki
        q = kc * dkp
        z = rc * dr - q
        later = torch.flip(torch.cumsum(torch.flip(z, [2]), 2), [2]) - z   # sum over tau > t
        x = torch.exp(c_l[:, :, 0]) * (gout * sin).sum(-1) + (kc * dki).sum(2)
        dlw = x[:, :, None] + later - q
        outs["dr"].append(dr + uf * kc * vg)
        outs["dk"].append(dkp + uf * rc * vg)
        outs["dv"].append(dvv)
        outs["dlw"].append(dlw)
        du += (rc * kc * vg).sum((0, 2))
    return (*(torch.cat(outs[n], 2)[:, :, :steps] for n in ("dr", "dk", "dv", "dlw")), du, ds0)


def _chunked_got(r, k, v, lw, u, s0, gy, gs):
    """The emulation on the bf16 values of one case, its dr, dk, dv, dlog_w
    rounded to bf16 as the kernel writes them."""
    got = _wkv6_chunked_bwd_emulation(*(_t(x) for x in (r, k, v, lw, u, s0, gy, gs)))
    assert all(torch.isfinite(g).all() for g in got)
    return [g.bfloat16() for g in got[:4]] + list(got[4:])


@pytest.mark.parametrize("dims,s0", [((1, 2, 150, 64, 64), True), ((1, 2, 70, 7, 5), True),
                                     ((2, 1, 9, 16, 16), False), ((1, 1, 64, 16, 16), False)])
def test_chunked_bwd_identities_match_the_step_loop_in_f64(dims, s0):
    """The chunked identities, unrounded in float64, against the plain
    reverse loop in float64: a ragged last chunk (T = 150: 64 + 64 + 22), an
    odd dk and dv, T < 16, s0 and gs_last given or not."""
    r, k, v, lw, u, s, gy, gs = _wkv_arrays(dims, seed=50, dtype="float32", s0=s0)
    ins = [None if x is None else torch.from_numpy(x).double()
           for x in (r, k, v, lw, u, s, gy, gs if s0 else None)]
    got = _wkv6_chunked_bwd_emulation(*ins, exact=True)
    want = wkv_ref.wkv6_scan_bwd(*ins)
    for name, g, w in zip(WKV_NAMES, got, want, strict=True):
        assert w.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10, rtol=1e-10, err_msg=name)


# (dims, with s0 and gs_last, log_w fixed or None): the reference shapes, a
# ragged T over several chunks from s0, odd dk and dv, extreme decay
CHUNKED_CASES = [(dims, False, None) for dims in WKV_CASES] + [
    ((1, 4, 200, 64, 64), True, None), ((1, 2, 70, 7, 5), True, None),
    ((1, 1, 64, 16, 16), False, -20.0)]


@pytest.mark.parametrize("dims,s0,log_w,against", [
    (dims, s0, lw, against) for dims, s0, lw in CHUNKED_CASES
    for against in (("scan",) if s0 else ("op", "scan"))])
def test_chunked_bwd_emulation_matches_jax(dims, s0, log_w, against):
    """The emulation of B5''s bf16 design against jax.vjp of the JAX op
    (Pallas forward in interpret mode; no s0) or of its reference scan, at
    the bf16 bound, cotangents on y and the last state.  The JAX side gets
    log_w as f32 holding the bf16 values (`_jax_log_w`)."""
    r, k, v, lw, u, s, gy, gs = _wkv_arrays(dims, seed=51, dtype="bfloat16", s0=s0,
                                            log_w=log_w)
    if against == "op":
        want = (*_vjp(lambda *xs: jax_wkv6(*xs),
                      (*(_j(x, "bfloat16") for x in (r, k, v)), _jax_log_w(lw, "bfloat16"),
                       _j(u)), (_j(gy, "bfloat16"), _j(gs))), None)
        got = _chunked_got(r, k, v, lw, u, None, gy, gs)
    else:
        def scan(r_, k_, v_, lw_, u_, s0_):
            return jax_wkv_ref.wkv6_scan(r_, k_, v_, jnp.exp(lw_), u_, s0_)
        s0_ = s if s0 else np.zeros((dims[0], dims[1], dims[3], dims[4]), np.float32)
        want = _vjp(scan, (*(_j(x, "bfloat16") for x in (r, k, v)), _j(lw), _j(u), _j(s0_)),
                    (_j(gy, "bfloat16"), _j(gs)))
        got = _chunked_got(r, k, v, lw, u, s0_, gy, gs)
    _assert_close(got, want, WKV_NAMES, tol("bfloat16", None))


# --- on the card ----------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _cuda(x, dtype="float32"):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, dtype)).cuda()


def _card_bounds(dtype, f32):
    return {"atol": 2e-2, "rtol": 2e-2} if dtype == "bfloat16" else {"atol": f32, "rtol": f32}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LRU_CASES + [(2, 1100, 48), (2, 37, 33), (2, 9, 40),
                                               (1, 5, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h0", [False, True])
def test_cuda_rg_lru_bwd_matches_plain(shape, dtype, h0):
    """B4' against its plain version; in f32 the same bits (one add and two
    multiplies a step, each rounded, in the plain version's order), and two
    runs give the same bits in both dtypes.  T below the ring's 16 steps a
    stage (9, 5; 1) and widths whose rows are (4096) and are not (33, 40 in
    bf16: 80 bytes) 16-byte aligned."""
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
                                              (1, 2, 70, 7, 5), (1, 2, 9, 64, 64),
                                              (2, 2, 1, 64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s0", [False, True])
def test_cuda_wkv6_bwd_matches_plain(dims, dtype, s0):
    """B5' against its plain version, from the forward's chunk-entry states
    (bf16, T > 1) or its own (f32, or T = 1), and two runs give the same
    bits.  Every bf16 call takes the chunked design (`launches_chunked`),
    T below a sub-block's 16 steps (7, 9) and T = 1 included."""
    _need_cuda()
    r, k, v, lw, u, s, gy, gs = _wkv_arrays(dims, seed=41, dtype=dtype, s0=s0)
    ins = (*(_cuda(x, dtype) for x in (r, k, v, lw)), _cuda(u), _cuda(s))
    tgy, tgs = _cuda(gy, dtype), _cuda(gs)
    _, _, ws = wkv_kernel.wkv6_fwd(*ins)
    assert (ws is not None) == (dtype == "bfloat16" and dims[2] > 1)
    fn = wkv_kernel.wkv6_bwd
    before = (fn.launches, fn.launches_chunked, fn.launches_entry)
    got = fn(*ins, tgy, tgs, ws)
    again = fn(*ins, tgy, tgs, ws)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_chunked, fn.launches_entry) == (
        before[0] + 2, before[1] + 2 * (dtype == "bfloat16"), before[2] + 2 * (ws is None))
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

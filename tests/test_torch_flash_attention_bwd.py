"""Port parity: the flash-attention backward (kernels B2, B3 and their plain
versions) vs the JAX package.

The same numpy inputs (from a seed) go through JAX — its Pallas backward
kernels in interpret mode, and `jax.grad` of its `ref.attention` oracle — and
through the port's op, which on CPU tensors runs the plain versions.  The
bound is the reference's own for its gradient test (tests/test_kernels.py):
atol = rtol = 1e-4, in f32.

The `cuda`-marked cases hold the CUDA kernels to the plain versions on the
card and skip without one; they import no JAX.  f32 is held at the same
1e-4.  bf16 is held at 2e-2 absolute + 2e-2 relative: both sides round their
outputs to bf16, whose spacing is 2^-8 relative, so they may differ by one
bf16 step (2^-7 = 7.8e-3 at values in [1, 2), 3.1e-2 in [4, 8)); and the
kernels' tensor-core variants round P and dS to bf16 before the dV and dK
products, and dS before the dQ product (the plain version multiplies them in
f32).  Plain emulations of that rounding are held to the same bound here on
the CPU, against the plain version and against the JAX Pallas backward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro_torch.kernels.flash_attention import kernel_bwd, ops, ref  # noqa: E402

TOL = {"atol": 1e-4, "rtol": 1e-4}
GRAD_CASES = [
    # b, hq, hkv, sq, d, causal, window, block (tests/test_kernels.py)
    (1, 2, 1, 64, 32, True, None, 32),    # GQA group-sum of dK/dV
    (2, 4, 2, 96, 32, True, None, 32),
    (1, 4, 4, 80, 16, True, 32, 32),      # sliding window + ragged seq
    (1, 2, 2, 48, 16, False, None, 16),   # bidirectional
]
# b, h, sq, sk, d, causal, window: MHA shapes for the backward kernels
BWD_CASES = [
    (1, 2, 64, 64, 32, True, None),
    (2, 4, 96, 96, 32, True, None),
    (1, 4, 80, 80, 16, True, 32),
    (1, 2, 48, 48, 16, False, None),
    (1, 4, 72, 72, 80, True, None),       # stablelm-3b head dim 80, ragged
    (1, 8, 8, 200, 32, True, None),       # sq << sk
]
TRAIN_CASE = (8, 32, 512, 512, 80, True, None)      # stablelm-3b, batch 8 x 512
WIDE_CASE = (1, 8, 300, 300, 256, True, 100)        # head dim 256 + window


def _grad_arrays(case, seed=0):
    b, hq, hkv, sq, d = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sq, d), (b, hkv, sq, d), (b, hq, sq, d))]


def _port_grads(q, k, v, g, causal, window):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(q, k, v, causal, window)
    return torch.autograd.grad((out * torch.from_numpy(g)).sum(), (q, k, v))


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_flash_attention_grad_matches_jax(case, against):
    """The port's autograd through `flash_attention` vs JAX's gradients through
    the Pallas backward kernels (interpret mode) or through the oracle."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ref as jax_ref
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    _, _, _, _, _, causal, window, blk = case
    q, k, v, g = _grad_arrays(case)

    def f_jax(q_, k_, v_):
        if against == "pallas":
            out = jax_flash(q_, k_, v_, causal, window, None, blk, blk)
        else:
            out = jax_ref.attention(q_, k_, v_, causal=causal, window=window)
        return (out * jnp.asarray(g)).sum()

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, g, causal, window)
    for name, a, b_ in zip("qkv", got, want, strict=True):
        assert a.shape == b_.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), err_msg=f"d{name}", **TOL)


def _mha_arrays(case, seed=1):
    b, h, sq, sk, d = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d))]


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_attention_bwd_matches_jax_kernel(case):
    """`ref.attention_bwd` vs the Pallas `flash_attention_bwd` (interpret),
    both fed the forward's output and logsumexp."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import flash_attention_fwd_lse as jax_fwd
    from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = _mha_arrays(case)
    scale = d ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, scale=scale, causal=causal, window=window,
                     block_q=32, block_k=32, interpret=True)
    want = jax_bwd(jq, jk, jv, o, lse, jdo, scale=scale, causal=causal, window=window,
                   block_q=32, block_k=32, interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    got = ref.attention_bwd(*t, scale=scale, causal=causal, window=window)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), err_msg=name, **TOL)


def test_wrappers_on_cpu_run_plain_versions_without_launch():
    """B2 and B3 wrappers on CPU tensors: the plain halves, no launch."""
    case = BWD_CASES[4]
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a) for a in _mha_arrays(case))
    o, lse = ref.attention_fwd_lse(q, k, v, scale=d ** -0.5, causal=causal, window=window)
    dvec = (do * o).sum(-1)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    dk, dv = kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
    want = ref.attention_bwd(q, k, v, o, lse, do, **kw)
    assert kernel_bwd.flash_attention_bwd_dkv.launches == 0
    assert kernel_bwd.flash_attention_bwd_dkv.launches_tc == 0
    assert kernel_bwd.flash_attention_bwd_dq.launches == 0
    assert kernel_bwd.flash_attention_bwd_dq.launches_tc == 0
    for a, b_ in zip((dq, dk, dv), want, strict=True):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6, rtol=1e-6)


def _tc_dkv_emulation(q, k, v, do, lse, dvec, *, scale, causal, window):
    """What the dK/dV kernel's bf16 tensor-core variant computes, in plain
    PyTorch: P and dS in f32 (dS from the unrounded P), rounded to bf16 before
    dV = P^T dO and dK = dS^T Q (products exact, sums in f32)."""
    p, ds = ref._bwd_probs(q, k, v, lse, do, dvec, scale, causal, window)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.bfloat16().float(), q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _tc_dq_emulation(q, k, v, do, lse, dvec, *, scale, causal, window):
    """What the dQ kernel's bf16 tensor-core variant computes, in plain
    PyTorch: dS in f32 from the unrounded P, rounded to bf16 before
    dQ = dS K (products exact, sums in f32)."""
    _, ds = ref._bwd_probs(q, k, v, lse, do, dvec, scale, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds.bfloat16().float(), k.float()).to(q.dtype)


@pytest.mark.parametrize("case", [
    (1, 4, 72, 72, 80, True, None),       # stablelm-3b's head dim, ragged
    (1, 2, 96, 96, 32, True, None),
    (1, 2, 80, 80, 256, True, 32),        # head dim 256 with a sliding window
])
def test_tensor_core_dq_rounding_matches_jax_kernel(case):
    """The one numerical change of B3's bf16 variant, rounding dS to bf16
    before dS K, stays inside the bf16 bound against the Pallas backward
    (interpret mode) fed the same bf16-exact inputs and the forward's
    output and logsumexp."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import flash_attention_fwd_lse as jax_fwd
    from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _mha_arrays(case, seed=6))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, **kw, block_q=32, block_k=32, interpret=True)
    want, _, _ = jax_bwd(jq, jk, jv, o, lse, jdo, **kw, block_q=32, block_k=32,
                         interpret=True)
    dvec = (do.float() * torch.from_numpy(np.array(o))).sum(-1)
    got = _tc_dq_emulation(q, k, v, do, torch.from_numpy(np.array(lse)), dvec, **kw)
    plain = ref.attention_bwd_dq(q, k, v, do, torch.from_numpy(np.array(lse)), dvec, **kw)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, plain)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", [
    (2, 4, 256, 256, 80, True, None),     # stablelm-3b's head dim, training
    (1, 4, 100, 300, 80, True, None),     # ragged, sq < sk
    (1, 2, 300, 300, 256, True, 100),     # head dim 256 with a sliding window
])
def test_tensor_core_rounding_fits_reference_bounds(case):
    """The one numerical change of B2's bf16 variant, rounding P and dS to
    bf16 before their products, stays inside the reference's bf16 bound
    against the plain version."""
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _mha_arrays(case, seed=4))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    o, lse = ref.attention_fwd_lse(q, k, v, **kw)
    dvec = (do.float() * o.float()).sum(-1)
    got = _tc_dkv_emulation(q, k, v, do, lse, dvec, **kw)
    want = ref.attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    for name, a, b_ in zip(("dk", "dv"), got, want, strict=True):
        assert a.dtype == torch.bfloat16 and not torch.equal(a, b_)
        np.testing.assert_allclose(a.float().numpy(), b_.float().numpy(), err_msg=name,
                                   atol=2e-2, rtol=2e-2)


# --- on the card ----------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _card_tol(dtype):
    return TOL if dtype == torch.float32 else {"atol": 2e-2, "rtol": 2e-2}


# The card's cases: the reference's shapes, the training shape, head dim 256
# with a window, and at every head dim ragged Sq and Sk (not multiples of 16
# or 64): Sq < Sk causal, Sq > Sk bidirectional, and a window.
CUDA_CASES = BWD_CASES + [TRAIN_CASE, WIDE_CASE] + [
    c for d in kernel_bwd.HEAD_DIMS
    for c in ((1, 2, 72, 300, d, True, None), (1, 2, 100, 72, d, False, None),
              (1, 2, 300, 300, d, True, 100))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernels_match_plain(case, dtype):
    _need_cuda()
    dtype = getattr(torch, dtype)
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).cuda().to(dtype) for a in _mha_arrays(case, seed=2))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    o, lse = ref.attention_fwd_lse(q, k, v, **kw)
    dkv, dq = kernel_bwd.flash_attention_bwd_dkv, kernel_bwd.flash_attention_bwd_dq
    before = (dkv.launches, dkv.launches_tc, dq.launches, dq.launches_tc)
    got = kernel_bwd.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    # bf16 runs B2's and B3's tensor-core variants, f32 their CUDA-core ones
    tc = int(dtype == torch.bfloat16)
    assert (dkv.launches, dkv.launches_tc, dq.launches, dq.launches_tc) == (
        before[0] + 1, before[1] + tc, before[2] + 1, before[3] + tc)
    want = ref.attention_bwd(q, k, v, o, lse, do, **kw)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.dtype == dtype and a.shape == b_.shape
        np.testing.assert_allclose(a.float().cpu().numpy(), b_.float().cpu().numpy(),
                                   err_msg=name, **_card_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [TRAIN_CASE, WIDE_CASE, (1, 2, 100, 300, 80, True, None)])
def test_cuda_bwd_dkv_bf16_is_bit_identical_across_runs(case):
    """No atomics and a fixed order of every sum: two runs of B2's tensor-core
    variant give the same bits."""
    _need_cuda()
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).cuda().bfloat16() for a in _mha_arrays(case, seed=5))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    o, lse = ref.attention_fwd_lse(q, k, v, **kw)
    dvec = (do.float() * o.float()).sum(-1)
    first, second = (kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b_ in zip(first, second, strict=True):
        assert torch.equal(a, b_) and torch.isfinite(a.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [TRAIN_CASE, WIDE_CASE, (1, 2, 100, 300, 80, True, None)])
def test_cuda_bwd_dq_bf16_is_bit_identical_across_runs(case):
    """No atomics and a fixed order of every sum: two runs of B3's tensor-core
    variant give the same bits."""
    _need_cuda()
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).cuda().bfloat16() for a in _mha_arrays(case, seed=5))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    o, lse = ref.attention_fwd_lse(q, k, v, **kw)
    dvec = (do.float() * o.float()).sum(-1)
    first, second = (kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.isfinite(first.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 4, 72, 72, 80, True, None), (1, 2, 80, 80, 256, True, 32)])
def test_cuda_bwd_dq_bf16_matches_its_emulation(case):
    """B3's bf16 variant against the plain emulation of its rounding: the
    same function up to the order of f32 sums and the exps."""
    _need_cuda()
    d, causal, window = case[4], case[5], case[6]
    q, k, v, do = (torch.from_numpy(a).cuda().bfloat16() for a in _mha_arrays(case, seed=6))
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    o, lse = ref.attention_fwd_lse(q, k, v, **kw)
    dvec = (do.float() * o.float()).sum(-1)
    got = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
    want = _tc_dq_emulation(q, k, v, do, lse, dvec, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAD_CASES)
def test_cuda_op_grads_match_cpu(case):
    """GQA, window and bidirectional through the op: the card's gradients
    (B1, B2, B3) against the CPU's (plain versions), f32."""
    _need_cuda()
    _, _, _, _, _, causal, window, _ = case
    q, k, v, g = _grad_arrays(case, seed=3)
    want = _port_grads(q, k, v, g, causal, window)
    tq, tk, tv = (torch.from_numpy(a).cuda().requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal, window)
    got = torch.autograd.grad((out * torch.from_numpy(g).cuda()).sum(), (tq, tk, tv))
    for a, b_ in zip(got, want, strict=True):
        np.testing.assert_allclose(a.cpu().numpy(), b_.numpy(), **TOL)


# MLA's training shape cut to a few heads, and a ragged one: query/key head 96,
# value head 64 (b, h, sq, sk, causal)
MLA_OP_CASES = [(2, 4, 512, 512, True), (1, 3, 72, 300, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_OP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_at_d96_through_the_op_matches_plain(case, dtype):
    """MLA's backward on the card: q/k heads of 96 and V of 64, which the op
    pads to 96, so that B2 and B3 run at D = 96 (the tensor-core variants in
    bf16); the gradients, V's sliced back through the pad, against the
    plain versions' on the same card at the bounds of this file."""
    _need_cuda()
    dtype = getattr(torch, dtype)
    b, h, sq, sk, causal = case
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
                  for s in ((b, h, sq, 96), (b, h, sk, 96), (b, h, sk, 64), (b, h, sq, 64)))
    scale = 96 ** -0.5
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    before = (kernel_bwd.flash_attention_bwd_dkv.launches_tc,
              kernel_bwd.flash_attention_bwd_dq.launches_tc)
    out = ops.flash_attention(tq, tk, tv, causal, None, scale)
    got = torch.autograd.grad((out.float() * g.float()).sum(), (tq, tk, tv))
    tc = int(dtype == torch.bfloat16)
    assert (kernel_bwd.flash_attention_bwd_dkv.launches_tc,
            kernel_bwd.flash_attention_bwd_dq.launches_tc) == (before[0] + tc, before[1] + tc)
    vp = torch.nn.functional.pad(v, (0, 32))
    o, lse = ref.attention_fwd_lse(q, k, vp, scale=scale, causal=causal, window=None)
    go = torch.nn.functional.pad(g, (0, 32)).to(dtype)
    want = ref.attention_bwd(q, k, vp, o, lse, go, scale=scale, causal=causal, window=None)
    want = (want[0], want[1], want[2][..., :64])
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.shape == b_.shape, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b_.float().cpu().numpy(),
                                   err_msg=name, **_card_tol(dtype))


@pytest.mark.cuda
def test_cuda_bwd_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    q = torch.randn(1, 2, 16, 48, device="cuda")
    lse = torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        kernel_bwd.flash_attention_bwd_dq(q, q, q, q, lse, lse, scale=1.0, causal=True,
                                          window=None)
    k = torch.randn(1, 1, 16, 32, device="cuda")
    q = torch.randn(1, 2, 16, 32, device="cuda")
    with pytest.raises(ValueError, match="MHA"):
        kernel_bwd.flash_attention_bwd_dkv(q, k, k, q, lse, lse, scale=1.0, causal=True,
                                           window=None)

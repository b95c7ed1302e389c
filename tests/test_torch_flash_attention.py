"""Port parity: flash attention's plain PyTorch versions vs the JAX package.

The same numpy inputs (from a seed) go through the JAX oracle / the JAX Pallas
kernel in interpret mode and through the port.  Bounds are the reference's
own (tests/test_kernels.py): 5e-5 in f32, 5e-2 in bf16, lse 1e-5 in f32.
Cases that need the card carry the `cuda` marker and skip without one; they
import no JAX, so on a machine with a card and no JAX they run with
`python -m pytest -m cuda tests/test_torch_flash_attention.py`.  The bf16
tensor-core variant rounds P to bf16 before P.V; a plain emulation of that
rounding is held to the same bf16 bounds here on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

FLASH_CASES = [
    # b, hq, hkv, sq, sk, d, causal, window  (tests/test_kernels.py FLASH_CASES)
    (2, 4, 2, 128, 128, 64, True, None),     # GQA causal
    (1, 2, 1, 100, 100, 32, True, None),     # ragged seq
    (1, 4, 4, 96, 96, 16, True, 32),         # sliding window
    (1, 4, 2, 160, 160, 32, True, 64),       # GQA + window
    (1, 2, 2, 64, 64, 16, False, None),      # bidirectional (encoder)
    (1, 8, 2, 8, 200, 32, True, None),       # chunked decode sq << sk
    (1, 1, 1, 64, 64, 128, True, None),      # wide head dim
    (1, 4, 4, 72, 72, 80, True, None),       # stablelm-3b head dim 80, ragged
]
DTYPES = ("float32", "bfloat16")


def tol(dtype):
    return ({"atol": 5e-2, "rtol": 5e-2} if dtype == "bfloat16"
            else {"atol": 5e-5, "rtol": 5e-5})


def _arrays(case, seed):
    b, hq, hkv, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _torch_inputs(case, dtype, seed=0):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in _arrays(case, seed)]


def _both_inputs(case, dtype, seed=0):
    """(JAX arrays, torch tensors) from the same numpy values; both sides
    round f32 to nearest-even bf16."""
    jnp = pytest.importorskip("jax.numpy")
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in _arrays(case, seed)],
            _torch_inputs(case, dtype, seed))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_attention_matches_jax_ref(case, dtype):
    from repro.kernels.flash_attention import ref as jax_ref
    causal, window = case[6], case[7]
    (jq, jk, jv), (tq, tk, tv) = _both_inputs(case, dtype)
    want = jax_ref.attention(jq, jk, jv, causal=causal, window=window)
    got = ref.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **tol(dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_fwd_lse_matches_jax_kernel(case, dtype):
    """The port's plain version of the kernel vs the Pallas kernel (interpret)."""
    d, causal, window = case[5], case[6], case[7]
    (jq, jk, jv), (tq, tk, tv) = _both_inputs(case, dtype, seed=1)
    from repro.kernels.flash_attention.kernel import flash_attention_fwd_lse as jax_fwd_lse
    scale = d ** -0.5
    want_o, want_lse = jax_fwd_lse(jq, jk, jv, scale=scale, causal=causal,
                                   window=window, interpret=True)
    got_o, got_lse = ref.attention_fwd_lse(tq, tk, tv, scale=scale, causal=causal,
                                           window=window)
    assert got_lse.dtype == torch.float32 and got_lse.shape == tq.shape[:3]
    np.testing.assert_allclose(_np(got_o), _np(want_o), **tol(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    case = FLASH_CASES[0]
    tq, tk, tv = _torch_inputs(case, "float32")
    before = kernel.flash_attention_fwd_lse.launches
    got = ops.flash_attention(tq, tk, tv, True, None)
    want = ref.attention(tq, tk, tv, causal=True)
    assert kernel.flash_attention_fwd_lse.launches == before == 0
    assert kernel.flash_attention_fwd_lse.launches_tc == 0
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=5e-5)


def _tc_fwd_emulation(q, k, v, *, scale, causal, window):
    """What the bf16 tensor-core variant computes, in plain PyTorch: 64-key
    tiles, an online softmax in f32 whose denominator sums the unrounded P,
    and P rounded to bf16 before P.V (products exact, sums in f32)."""
    sq, sk = q.shape[2], k.shape[2]
    s = ref._scores(q, k, scale)
    s = s.masked_fill(~ref.attention_mask(sq, sk, causal, window), ref.NEG_INF)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1).float()
    m = torch.full(s.shape[:3], ref.NEG_INF)
    l = torch.zeros(s.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk, 64):
        tile = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ v[..., k0:k0 + 64, :]
        m = m_new
    denom = l.clamp_min(1e-30)
    return (acc / denom[..., None]).to(q.dtype), m + torch.log(denom)


@pytest.mark.parametrize("case", [
    (1, 4, 4, 256, 256, 80, True, None),     # stablelm-3b's head dim, serving and training
    (1, 4, 2, 100, 300, 80, True, None),     # ragged, sq < sk, GQA
    (1, 2, 1, 300, 300, 256, True, 100),     # head dim 256, MQA, sliding window
])
def test_tensor_core_rounding_fits_reference_bounds(case):
    """The one numerical change of the bf16 variant, rounding P to bf16 before
    P.V, stays inside the reference's bf16 bounds against the plain version."""
    d, causal, window = case[5], case[6], case[7]
    tq, tk, tv = _torch_inputs(case, "bfloat16", seed=4)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    got_o, got_lse = _tc_fwd_emulation(tq, tk, tv, **kw)
    want_o, want_lse = ref.attention_fwd_lse(tq, tk, tv, **kw)
    assert got_o.dtype == torch.bfloat16 and not torch.equal(got_o, want_o)
    np.testing.assert_allclose(_np(got_o), _np(want_o), **tol("bfloat16"))
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=1e-3, rtol=1e-3)


def _chip_smoke():
    """The card script's checks, imported from the root of the checkout."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    return importlib.import_module("chip_smoke")


# chip_smoke.py's B1 serving shapes with fewer heads (whisper-base's encoder,
# cross attention in prefill and decode; internvl2-26b's GQA 6:1 over 1536;
# D = 96 as MLA's; D = 256 with a window as recurrentgemma's) and the
# reference's causal GQA case
ROW_SCALED_CASES = [
    (1, 2, 2, 1500, 1500, 64, False, None),
    (1, 4, 4, 64, 1500, 64, False, None),
    (4, 8, 8, 1, 1500, 64, False, None),
    (1, 6, 1, 1536, 1536, 128, True, None),
    (1, 4, 4, 512, 512, 96, True, None),
    (1, 4, 1, 512, 512, 256, True, 100),
    (2, 4, 2, 128, 128, 64, True, None),
]


@pytest.mark.parametrize("case", ROW_SCALED_CASES)
def test_tensor_core_rounding_fits_the_row_scaled_bf16_check(case):
    """chip_smoke.py holds every bf16 output of B1 to its own row's scale as
    well as to TOL; the bf16 variant's rounding of P stays well inside that
    bound (below half of it)."""
    cs = _chip_smoke()
    d, causal, window = case[5], case[6], case[7]
    tq, tk, tv = _torch_inputs(case, "bfloat16", seed=5)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    got, _ = _tc_fwd_emulation(tq, tk, tv, **kw)
    want, _ = ref.attention_fwd_lse(tq, tk, tv, **kw)
    ratio, ok = cs.bf16_row_err(got, want)
    assert ok and ratio < cs.BF16_ROW_TOL / 2, ratio


@pytest.mark.parametrize("case", ROW_SCALED_CASES[:3])
def test_row_scaled_bf16_check_fails_a_lost_partial_key_tile(case):
    """V read as zeros in the last, partial key tile (1500 = 23 * 64 + 28)
    moves whisper's outputs, of rms ~0.04, by up to 3e-2 for a decode query:
    inside TOL[bf16], so that check alone can pass it.  The row-scaled check
    fails it at every whisper shape."""
    cs = _chip_smoke()
    d, causal, window = case[5], case[6], case[7]
    tq, tk, tv = _torch_inputs(case, "bfloat16", seed=5)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    want, _ = ref.attention_fwd_lse(tq, tk, tv, **kw)
    lost = tv.clone()
    lost[..., tv.shape[2] // 64 * 64:, :] = 0
    got, _ = _tc_fwd_emulation(tq, tk, lost, **kw)
    ratio, ok = cs.bf16_row_err(got, want)
    assert not ok and ratio > 10 * cs.BF16_ROW_TOL, ratio


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


# The card's cases: the reference's shapes, gemma3's head dim 256 with GQA and
# a window, and at every head dim ragged Sq and Sk (not multiples of 16 or 64)
# with Sq < Sk under GQA, and with Sq > Sk bidirectional.
CUDA_CASES = FLASH_CASES + [(1, 8, 4, 300, 300, 256, True, 100),
                            (2, 4, 1, 300, 300, 80, True, 100)] + [
    c for d in kernel.HEAD_DIMS
    for c in ((1, 4, 2, 72, 300, d, True, None), (1, 2, 2, 100, 72, d, False, None))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(case, dtype):
    _need_cuda()
    d, causal, window = case[5], case[6], case[7]
    tq, tk, tv = (t.cuda() for t in _torch_inputs(case, dtype, seed=2))
    fn = kernel.flash_attention_fwd_lse
    before = (fn.launches, fn.launches_tc)
    got_o, got_lse = fn(tq, tk, tv, scale=d ** -0.5, causal=causal, window=window)
    torch.cuda.synchronize()
    # bf16 runs the tensor-core variant, f32 the CUDA-core one
    assert (fn.launches, fn.launches_tc) == (before[0] + 1,
                                             before[1] + (dtype == "bfloat16"))
    want_o, want_lse = ref.attention_fwd_lse(tq, tk, tv, scale=d ** -0.5,
                                             causal=causal, window=window)
    np.testing.assert_allclose(_np(got_o.cpu()), _np(want_o.cpu()), **tol(dtype))
    lse_tol = 1e-5 if dtype == "float32" else 1e-3   # both sides: lse in f32
    np.testing.assert_allclose(_np(got_lse.cpu()), _np(want_lse.cpu()),
                               atol=lse_tol, rtol=lse_tol)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _need_cuda()
    q = torch.randn(1, 2, 16, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention_fwd_lse(q, q, q, scale=1.0, causal=True, window=None)
    q = torch.randn(1, 16, 2, 32, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention_fwd_lse(q, q, q, scale=1.0, causal=True, window=None)
    q = torch.randn(1, 2, 16, 32, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        kernel.flash_attention_fwd_lse(q, q, q, scale=1.0, causal=True, window=None)

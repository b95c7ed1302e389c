"""Functional building blocks of the port (parameters are dicts of tensors).

Each function mirrors `repro.models.layers` and keeps its cast points: `dot`
returns float32 whatever the operand dtype, each caller casts back to the
activation dtype, and `unembed` does not, so logits are float32 even for a
bf16 model.  Initialisers draw from an explicit `torch.Generator` with the
JAX initialisers' scales; the draws are the port's own, not JAX's bits.

Under tensor parallelism (`tensor_parallel`; a parameter group read with its
'model' shards kept) the FFNs run column-parallel then row-parallel, the row
product's float32 partial sums all-reduced before the cast (as XLA reduces
a `preferred_element_type=f32` product before the model's `astype`), and
the embedding and unembedding run vocab-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tensor_parallel as tp


class _DotF32(torch.autograd.Function):
    """x (N, d_in) @ w (d_in, d_out), or a batch of them, x (B, N, d_in) @
    w (B, d_in, d_out), in half precision with f32 accumulation and an f32
    result, on the card.

    `torch.mm(..., out_dtype=torch.float32)` and `torch.bmm`'s have no
    derivative (`aten::mm.dtype` raises "derivative for aten::mm is not
    implemented"), so the backward is written here: g w^T and x^T g from f32
    copies of the operands, cast to the operands' dtypes, as JAX transposes a
    `preferred_element_type=f32` dot.
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return (torch.mm if x.dim() == 2 else torch.bmm)(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.matmul(g, w.float().mT).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.float().mT, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def dot(x, w):
    """x (..., d_in) @ w (d_in, d_out), or x (B, N, d_in) @ a stack of B
    weights w (B, d_in, d_out) (the MoE experts: `jnp.einsum("ecd,edf->ecf",
    preferred_element_type=f32)`), with a float32 result.  Operands of two
    dtypes (the MoE router: bf16 activations, f32 weights) are promoted to
    float32 first, as JAX promotes them."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda and x.dtype == w.dtype:  # half precision, f32 accumulation and output
        if w.dim() == 3:
            return _DotF32.apply(x, w)
        y = _DotF32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def normal_init(generator, shape, scale, dtype):
    """N(0, 1) in float32 from `generator`, scaled, then cast to `dtype`.
    Scaled in place: the same bits as `(x * scale).to(dtype)`, with one
    float32 copy of the leaf less in flight (arctic-480b's expert stacks
    are 17.9 GB each in float32)."""
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# --- norms --------------------------------------------------------------------


def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def init_layernorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# --- FFN ------------------------------------------------------------------------


def init_swiglu(generator, d, d_ff, dtype):
    s_in, s_ff = d ** -0.5, d_ff ** -0.5
    return {
        "w_gate": normal_init(generator, (d, d_ff), s_in, dtype),
        "w_up": normal_init(generator, (d, d_ff), s_in, dtype),
        "w_down": normal_init(generator, (d_ff, d), s_ff, dtype),
    }


def row_parallel(h, w, split: bool):
    """h @ w in float32: where `split`, this rank's rows of w, the partial
    products summed over 'model'."""
    y = dot(h, w)
    return tp.reduce(y) if split else y


def swiglu(p, x):
    split = tp.is_split(p, "w_gate")
    xi = tp.copy(x) if split else x
    g = dot(xi, p["w_gate"])
    u = dot(xi, p["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    return row_parallel(h, p["w_down"], split).to(x.dtype)


def init_gelu_mlp(generator, d, d_ff, dtype):
    dev = generator.device
    return {
        "w_in": normal_init(generator, (d, d_ff), d ** -0.5, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": normal_init(generator, (d_ff, d), d_ff ** -0.5, dtype),
        "b_out": torch.zeros((d,), dtype=dtype, device=dev),
    }


def local_cols(t, n: int, dim: int = -1):
    """This 'model' rank's n entries of `t` along `dim` (a leaf gathered
    whole and read in a per-rank computation)."""
    return t.narrow(dim, tp.rank() * n, n)


def gelu_mlp(p, x):
    """`jax.nn.gelu` defaults to the tanh approximation; `F.gelu` to the
    exact erf form, so the approximation is named here.  Under tensor
    parallelism b_in is cut to the rank's channels and b_out added once,
    after the reduce."""
    split = tp.is_split(p, "w_in")
    xi = tp.copy(x) if split else x
    b_in = local_cols(p["b_in"], p["w_in"].shape[1]) if split else p["b_in"]
    h = F.gelu(dot(xi, p["w_in"]) + b_in.float(), approximate="tanh")
    return (row_parallel(h.to(x.dtype), p["w_out"], split) + p["b_out"].float()).to(x.dtype)


# --- embeddings / head -----------------------------------------------------------


def init_embedding(generator, vocab, d, dtype):
    return {"table": normal_init(generator, (vocab, d), d ** -0.5, dtype)}


def embed(p, tokens):
    """The table's rows; vocab-parallel (the table's 'model' shard kept):
    each rank looks up the tokens in its rows, zeros elsewhere, and the
    rows are summed over 'model' (exact: one rank gives each token's row)."""
    table = p["table"]
    if not tp.is_split(p, "table"):
        return table[tokens]
    n = table.shape[0]
    local = tokens - tp.rank() * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def unembed(p, x, gather: bool = True):
    """Logits (float32); when tied, p is the embedding table.  Vocab-parallel,
    each rank computes its vocab's logits and, where `gather`, they are
    gathered over 'model' along the vocab (whole on every rank)."""
    key = "table" if "table" in p else "w"
    if not tp.is_split(p, key):
        return dot(x, p["table"].T) if key == "table" else dot(x, p["w"])
    w = p["table"].T if key == "table" else p["w"]
    logits = dot(tp.copy(x), w)
    return tp.gather(logits, -1) if gather else logits


def init_unembed(generator, d, vocab, dtype):
    return {"w": normal_init(generator, (d, vocab), d ** -0.5, dtype)}


# --- rotary position embedding ----------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, H, S, D); positions: (B, S) int.  Rotates interleaved pairs
    (x[..., 0::2], x[..., 1::2]), as the JAX package does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    ang = positions[:, None, :, None].float() * freqs            # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None):
    """(seq, d) float32: sines of the d / 2 frequencies, then their cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- misc --------------------------------------------------------------------------


def init_linear(generator, d_in, d_out, dtype, bias=False):
    p = {"w": normal_init(generator, (d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def linear(p, x):
    y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)

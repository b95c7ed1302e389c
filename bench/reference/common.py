"""Arithmetic the plain references share: the matrix product in the
precision a run asks for, the root-mean-square norm, and AdamW.

`prec` is "f32" (the reference: float32 with TF32 off, see `strict_f32`) or
"fp8" (the control: every product's operands rounded to float8 e4m3 with one
scale a tensor, its absolute max mapped to 448, as an fp8 GEMM reads them,
and in the backward the incoming gradient rounded alike; the sums stay in
float32).  Nothing here imports the program under test.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def strict_f32() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to float8 e4m3 under one scale a tensor, back in
    float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Operand(torch.autograd.Function):
    """An fp8 GEMM's operand: rounded on the way in, and the gradient that
    comes back through it rounded too (the backward GEMM's operand)."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.float()
    if prec == "f32":
        return x
    if prec == "fp8":
        return _Fp8Operand.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x @ w (matmul broadcasting) in float32 from operands in `prec`."""
    return torch.matmul(operand(x, prec), operand(w, prec))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def lr_at(step: int, base: float, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up to `base` over `warmup` steps, then a cosine to
    `min_ratio` of it at `total`; `step` counts from 1 at the first update."""
    if step < warmup:
        return base * (step + 1) / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw_step(params: list, grads: list, m: list, v: list, step: int, lr: float, *,
               b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.1, max_grad_norm: float = 1.0,
               store_dtype=None) -> float:
    """One AdamW update with global-norm clipping, in float32, in place.
    `params` are float32 tensors; after the update each is rounded to
    `store_dtype` (the dtype the configuration keeps its parameters in) and
    back, so the next step reads what a model stored in that dtype holds.
    Returns the gradient's global norm before clipping."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() * g.double())) for g in grads))
    scale = min(max_grad_norm / max(gnorm, 1e-12), 1.0)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, mi, vi in zip(params, grads, m, v, strict=True):
        gs = g * scale
        mi.mul_(b1).add_((1 - b1) * gs)
        vi.mul_(b2).add_((1 - b2) * gs * gs)
        new = p - lr * ((mi / bc1) / (torch.sqrt(vi / bc2) + eps) + weight_decay * p)
        p.copy_(new.to(store_dtype).float() if store_dtype is not None else new)
    return gnorm

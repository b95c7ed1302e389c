#!/usr/bin/env python3
"""How much a model's bf16 loss moves when only the order of its products'
sums changes, on one CUDA card.

Tensor parallelism sums each row-parallel product's partial sums over the
'model' ranks (in f32, before the cast) and computes the column-parallel
ones on narrower matrices, so its bf16 activations differ from one card's
by rounding alone.  This script makes that kind of change on one card: for
each arch (full published config, bf16, random weights from seed 0, the
global batch of `chip_smoke.py`'s phase 9 `tp_whole`: 8 x 512, SyntheticLM
seed 0), it runs the forward once as it is and once with every 2-D
product's contraction cut into 4 parts whose f32 products are summed in
f32 (what a 4-way row-parallel split computes), and prints the two mean
NLLs, their relative difference, and the per-token NLL differences: the
largest, the count above 0.1 and 1, and the share of the summed absolute
difference held by the 10 largest.  For RWKV-6 it also counts the (token,
head) pairs whose group-norm variance lies below the norm's eps (1e-5),
where rsqrt(var + eps) scales rounding up to ~316 times.  Prints the
card's name and power limit.  Exits non-zero without a CUDA card.

Run from the root of a checkout:

    python3 order_readings.py [ARCH ...]   # default: rwkv6-3b recurrentgemma-9b
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models import layers, recurrent  # noqa: E402

PARTS = 4
BATCH, SEQ, SEED = 8, 512, 0


def split_dot(dot):
    """`dot` with a 2-D weight's contraction cut into PARTS, summed in f32."""
    def cut(x, w):
        k = x.shape[-1]
        if w.dim() != 2 or k % PARTS:
            return dot(x, w)
        step = k // PARTS
        out = dot(x[..., :step], w[:step])
        for i in range(1, PARTS):
            out = out + dot(x[..., i * step:(i + 1) * step], w[i * step:(i + 1) * step])
        return out
    return cut


def token_nll(cfg, model, batch) -> torch.Tensor:
    with torch.no_grad():
        logits = forward(cfg, model, batch, mode="train").logits.float()
        return F.cross_entropy(logits.flatten(0, 1), batch["labels"].long().flatten(),
                               reduction="none")


def reading(arch: str) -> None:
    cfg = configs.get(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg.vocab_size, SEQ, seed=SEED).global_batch(
                 0, BATCH, 1).items()}
    low, seen = [], recurrent._group_norm

    def spy(scale, bias, y):
        var = ((y - y.mean(-1, keepdim=True)) ** 2).mean(-1)
        low.append((int((var < 1e-5).sum()), var.numel()))
        return seen(scale, bias, y)

    recurrent._group_norm = spy
    try:
        base = token_nll(cfg, model, batch)
    finally:
        recurrent._group_norm = seen
    dot = layers.dot
    layers.dot = split_dot(dot)
    try:
        moved = token_nll(cfg, model, batch)
    finally:
        layers.dot = dot
    diff = (moved - base).abs()
    top = diff.topk(10).values
    a, b = base.mean().item(), moved.mean().item()
    text = (f"{arch} ({cfg.num_layers} layers, {cfg.dtype}, {BATCH} x {SEQ}): mean NLL {a} as it is, "
            f"{b} with every product's sum cut in {PARTS}: relative {abs(b - a) / a:.3e}; "
            f"per-token |difference| largest {diff.max().item():.4f}, above 0.1: "
            f"{int((diff > 0.1).sum())}, above 1: {int((diff > 1).sum())} of {diff.numel()}, "
            f"the 10 largest hold {top.sum().item() / diff.sum().item() * 100:.1f} % of the "
            f"summed |difference| {diff.sum().item():.4f}")
    if low:
        n, total = sum(x for x, _ in low), sum(t for _, t in low)
        text += (f"; group-norm (token, head) pairs with variance under 1e-5: {n} of {total} "
                 f"over {len(low)} layers")
    print(text, flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("order_readings: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for arch in sys.argv[1:] or ("rwkv6-3b", "recurrentgemma-9b"):
        reading(arch)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Readings of the WKV-6 backward (B5') in rwkv6-3b's own regime, on one CUDA card.

Run from the root of a checkout:

    python3 bwd_readings.py grads                      # B5' on the model's inputs
    python3 bwd_readings.py train kernel               # 4 training steps with B5'
    python3 bwd_readings.py train plain                # ... with the plain backward
    python3 bwd_readings.py train kernel --src OTHER/src   # ... with another tree's B5'

`grads`: rwkv6-3b at full width cut to 4 layers, bf16, batch 8 x 512 (the
training shape), random weights from seed 0.  It captures the inputs of
each B5' call of one backward and holds the kernel's outputs to the plain
backward (`ref.wkv6_scan_bwd`) on them, norm-wise and against the bf16
bound 2e-2 + 2e-2|want|, and checks that a second call gives the same
bits; then it compares the model's gradients with B5' and with the plain
backward in its place, leaf by leaf.  `train`: rwkv6-3b whole, trained 4
steps through `train()` as `chip_smoke.py`'s phase 8 does (bf16, full
remat, `bridge` on one rank), with B5' or with the plain backward in its
place, from this checkout's tree or `--src`'s; it prints each step's loss,
gradient norm and time.  Prints the card's name and power limit.  Exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch


def plain_bwd(wkv_ref):
    """The op's backward with the plain reverse loop in B5''s place."""
    return lambda r, k, v, lw, u, s0, gy, gs, ws: wkv_ref.wkv6_scan_bwd(r, k, v, lw, u, s0, gy, gs)


def grads() -> None:
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel, ops as wkv_ops, ref as wkv_ref
    from repro_torch.models import init_params
    from repro_torch.models.model import loss_fn

    cfg = dataclasses.replace(configs.get("rwkv6-3b"), num_layers=4)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    data = SyntheticLM(cfg.vocab_size, 512, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.global_batch(0, 8, 1).items()}
    calls, kernel_bwd = [], wkv_ops.wkv6_bwd

    def capture(*args):
        out = kernel_bwd(*args)
        calls.append((args, out))
        return out

    wkv_ops.wkv6_bwd = capture
    loss, _ = loss_fn(cfg, model, batch)
    loss.backward()
    wkv_ops.wkv6_bwd = kernel_bwd
    with_kernel = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    print(f"rwkv6-3b (4 layers, {cfg.dtype}, 8 x 512): loss {loss.item():.7f}, {len(calls)} B5' calls")
    for i, (args, out) in enumerate(calls):
        r, k, v, lw, u, s0, gy, gs, ws = args
        want = wkv_ref.wkv6_scan_bwd(r, k, v, lw, u, s0, gy, gs)
        again = wkv_kernel.wkv6_bwd(*args)
        parts = []
        for name, a, b in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"), out, want, strict=True):
            a, b = a.float(), b.float()
            rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            ratio = ((a - b).abs() / (2e-2 + 2e-2 * b.abs())).max().item()
            parts.append(f"{name} {rel:.3e} ({ratio:.3f} of the bound)")
        same = all(torch.equal(x, y) for x, y in zip(out, again, strict=True))
        print(f"call {i}: log_w in [{lw.float().min().item():.4g}, {lw.float().max().item():.4g}], "
              f"max|gy| {gy.float().abs().max().item():.4g}; ||kernel - plain|| / ||plain||: "
              f"{', '.join(parts)}; the same bits twice {same}")
    model.zero_grad(set_to_none=True)
    wkv_ops.wkv6_bwd = plain_bwd(wkv_ref)
    loss_fn(cfg, model, batch)[0].backward()
    rows = sorted((((with_kernel[n] - p.grad.float()).norm()
                    / p.grad.float().norm().clamp_min(1e-30)).item(), n)
                  for n, p in model.named_parameters())
    print("model gradients, B5' against the plain backward, worst leaves (relative norm "
          "error): " + ", ".join(f"{n} {e:.3e}" for e, n in rows[::-1][:5]))
    norm = lambda gs: torch.sqrt(sum((g.float() ** 2).sum() for g in gs)).item()  # noqa: E731
    print(f"global gradient norm: B5' {norm(with_kernel.values()):.4f}, plain "
          f"{norm(p.grad for p in model.parameters()):.4f}")


def train(backward: str) -> None:
    from repro_torch.kernels.wkv6 import ops as wkv_ops, ref as wkv_ref
    from repro_torch.launch import train as train_mod

    if backward == "plain":
        wkv_ops.wkv6_bwd = plain_bwd(wkv_ref)
    tc = train_mod.TrainConfig(arch="rwkv6-3b", scale="full", steps=4, batch_size=8, seq_len=512,
                               grad_sync="bridge", seed=0)
    _, _, losses = train_mod.train(tc, progress=print, device="cuda")
    print(f"rwkv6-3b trained with {backward} B5' from {Path(wkv_ops.__file__).parents[3]}: "
          f"losses {losses}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("grads", "train"))
    parser.add_argument("backward", nargs="?", default="kernel", choices=("kernel", "plain"))
    parser.add_argument("--src", default=str(Path(__file__).resolve().parent / "src"),
                        help="the src directory whose repro_torch runs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_readings: no CUDA device; this script runs only on the card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip())
    grads() if args.what == "grads" else train(args.backward)


if __name__ == "__main__":
    main()

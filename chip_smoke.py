#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py     # one card; with two or more, phase 9 runs too

Phases, in order; any failure raises and the script exits non-zero:
  1. device  - require CUDA; print the card's name and power limit; TF32 off.
  2. build   - build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc.
  3. kernels - every kernel against its plain PyTorch version on the card: the
               forward B1 at the reference test shapes, the serving shape and
               the training shape; the backward B2 (dK/dV) and B3 (dQ) at the
               reference gradient shapes, the training shape, a GQA case on
               several seeds and a D = 256 window case.  Each check draws its
               inputs from a generator of its own and prints their hash.
  4. timing  - each kernel, its plain version and one PyTorch library call
               (CUDA events), beside the card's bound, at the shape each path
               gives it: B1 at the serving and the training shape, B2 and B3
               at the training shape.
  5. parity  - stablelm-3b at full width cut to 4 layers, f32: the same weights
               on the card (kernel) and on the CPU (plain version) give the
               same prefill and decode logits.
  6. train parity - stablelm-3b at full width cut to 2 layers, f32, 2 x 128
               tokens: the same weights on the card (B1, B2, B3) and on the CPU
               (plain versions) give the same loss and gradients.
  7. serve   - stablelm-3b at its full published config (32 layers, bf16,
               random weights from a seed) answers 4 requests of 512-token
               prompts with 32 new tokens each through
               `repro_torch.launch.serve.serve_requests`; the kernel launch
               counts of that run are read and checked.
  8. train (the main path) - stablelm-3b at its full published config, bf16,
               full remat, batch 8 x 512, grad_sync "bridge": 1 warm-up step
               and 3 timed steps through `repro_torch.launch.train.train`; the
               launch counts of that run are read and checked (B1 64, B2 32,
               B3 32 per step).
  9. multi-card - only with two or more cards: torchrun starts min(4, count)
               NCCL ranks (this script with --rank), which run the Bruck, ring
               and Bridge all-reduce against dist.all_reduce, time the shift
               latencies behind the H100_NVLINK cost model, and train the full
               config 2 steps through `train()` with grad_sync "gspmd" and
               "bridge"; the losses must agree with each other and with the
               main path's.  With one card it says that it did not run.
Then it prints the kernels' JSON line (one entry per kernel and path, each
with the numbers of the shape that path gives it), the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.  Imports nothing
of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import time
import zlib
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402  (fails outside a checkout)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, serve_requests  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, prefill  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core FLOP/s.  They assume the full 700 W power limit.
H100_HBM_BYTES_S = 3.35e12
H100_BF16_FLOP_S = 989e12

# b, hq, hkv, sq, sk, d, causal, window: the reference's kernel test shapes
# (tests/test_kernels.py FLASH_CASES) ...
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 2, 1, 100, 100, 32, True, None),
    (1, 4, 4, 96, 96, 16, True, 32),
    (1, 4, 2, 160, 160, 32, True, 64),
    (1, 2, 2, 64, 64, 16, False, None),
    (1, 8, 2, 8, 200, 32, True, None),
    (1, 1, 1, 64, 64, 128, True, None),
]
# ... the serving shape (stablelm-3b prefill: 4 prompts of 512, 32 heads of 80),
# the training shape (batch 8 x 512) and gemma3's head dim 256 with GQA and a
# sliding window.
SERVE_CASE = (4, 32, 32, 512, 512, 80, True, None)
TRAIN_FWD_CASE = (8, 32, 32, 512, 512, 80, True, None)
WIDE_CASE = (1, 8, 4, 300, 300, 256, True, 100)
TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}  # tests/test_kernels.py bounds
LSE_TOL = {torch.float32: 1e-5,  # f32 lse, same source
           # both sides compute lse in f32 from the same bf16 inputs
           torch.bfloat16: 1e-3}
MODEL_TOL = 2e-3        # prefill/decode bound of tests/test_models_smoke.py
SEED = 0

# B2 / B3: b, h, sq, sk, d, causal, window (MHA: the op expands GQA first).
# The reference's gradient shapes (tests/test_kernels.py) after expansion ...
BWD_CASES = [
    (1, 2, 64, 64, 32, True, None),
    (2, 4, 96, 96, 32, True, None),
    (1, 4, 80, 80, 16, True, 32),
    (1, 2, 48, 48, 16, False, None),
]
# ... the training shape (stablelm-3b, batch 8 x 512, 32 heads of 80) and
# gemma3's head dim 256 with a sliding window.
TRAIN_CASE = (8, 32, 512, 512, 80, True, None)
WIDE_BWD_CASE = (1, 8, 300, 300, 256, True, 100)
GQA_CASE = (1, 8, 2, 160, 160, 32, True, 64)      # through the op: b, hq, hkv, s, s, d, ...
GQA_SEEDS = range(5)
# f32: the reference's gradient bound (tests/test_kernels.py).  bf16: both sides
# compute in f32 from the same bf16 inputs and round to bf16 (spacing 2^-8
# relative), so they may differ by one bf16 step: 2e-2 + 2e-2 |want|.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU training parity, f32 through 2 full-width layers: loss rtol and
# the per-leaf relative error ||got - want|| / ||want|| of every gradient
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEPS = 4          # 1 warm-up + 3 timed
LOSS_RTOL = 2e-4         # bridge vs gspmd (tests/_distributed_worker.py)
MULTI_SIZES_MB = (1, 256)  # all-reduce payloads of the multi-card phase
MULTI_STEPS = 2            # training steps per grad-sync mode there


def phase(name: str):
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def case_generator(*key) -> torch.Generator:
    """A fresh generator for one check, seeded from SEED and the check's key:
    a check's inputs depend on its own case only, not on the checks before it."""
    return torch.Generator(device="cuda").manual_seed(SEED + zlib.crc32(repr(key).encode()))


def input_hash(*tensors) -> str:
    """Short hash of the tensors' values, printed so that runs can be shown to
    have had the same inputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def flash_inputs(case):
    """q, k, v of a B1 case in f32 on the card (cast by the caller)."""
    b, hq, hkv, sq, sk, d = case[:6]
    gen = case_generator("fwd", case)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    return [torch.randn(s, generator=gen, device="cuda") for s in shapes]


def max_err(got, want, atol, rtol):
    """(max abs error, whether |got - want| <= atol + rtol |want| everywhere)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def check_kernels() -> dict:
    """Kernel vs plain version on the card; returns the bf16 errors at the
    serving and the training shape, keyed by the case."""
    errs = {}
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16) for c in FLASH_CASES]
    cases += [(c, dt) for c in (SERVE_CASE, TRAIN_FWD_CASE, WIDE_CASE)
              for dt in (torch.bfloat16, torch.float32)]
    for case, dtype in cases:
        d, causal, window = case[5], case[6], case[7]
        q, k, v = (t.to(dtype) for t in flash_inputs(case))
        out, lse = flash_kernel.flash_attention_fwd_lse(
            q, k, v, scale=d ** -0.5, causal=causal, window=window)
        torch.cuda.synchronize()
        want_out, want_lse = flash_ref.attention_fwd_lse(
            q, k, v, scale=d ** -0.5, causal=causal, window=window)
        err, ok = max_err(out, want_out, TOL[dtype], TOL[dtype])
        lse_err, lse_ok = max_err(lse, want_lse, LSE_TOL[dtype], LSE_TOL[dtype])
        ok = ok and lse_ok
        line = (f"flash {case} {str(dtype)[6:]} inputs {input_hash(q, k, v)}: out "
                f"max|err| {err:.3e} (tol {TOL[dtype]}), lse max|err| {lse_err:.3e} "
                f"(tol {LSE_TOL[dtype]})")
        print(line)
        if not ok or out.shape != q.shape or lse.shape != q.shape[:3]:
            raise AssertionError(f"kernel disagrees with its plain version: {line}")
        if dtype == torch.bfloat16:  # the main paths' dtype
            errs[case] = err
    return errs


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(moved_bytes: int, flops: int) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on the published H100 SXM peaks."""
    t_bytes = moved_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = flops / H100_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_flash(case) -> dict:
    """B1 at `case`, bf16: kernel, plain, library, bound."""
    b, hq, hkv, sq, sk, d, causal, window = case
    q, k, v = (t.to(torch.bfloat16) for t in flash_inputs(case))
    scale = d ** -0.5
    fns = {
        "ms": lambda: flash_kernel.flash_attention_fwd_lse(
            q, k, v, scale=scale, causal=causal, window=window),
        "plain_ms": lambda: flash_ref.attention_fwd_lse(
            q, k, v, scale=scale, causal=causal, window=window),
        "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale),
    }
    runs = {key: [] for key in fns}
    for _ in range(3):  # in turns, median of three
        for key, fn in fns.items():
            runs[key].append(time_ms(fn))
    times = {key: sorted(v)[1] for key, v in runs.items()}
    # bound: each input read once and each output written once, against the
    # live (query, key) pairs of this mask at 4 D FLOPs each (QK^T and PV)
    elem = q.element_size()
    moved = (q.numel() * 2 + k.numel() + v.numel()) * elem + b * hq * sq * 4
    live = int(flash_ref.attention_mask(sq, sk, causal, window).sum())
    flops = 4 * d * live * b * hq
    t_bytes, t_ops = moved / H100_HBM_BYTES_S * 1e3, flops / H100_BF16_FLOP_S * 1e3
    times["bound_ms"] = max(t_bytes, t_ops)
    times["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"flash timing {case} bf16: kernel_ms {times['ms']:.4f} "
          f"plain_ms {times['plain_ms']:.4f} library_ms {times['library_ms']:.4f} "
          f"bound_ms {times['bound_ms']:.4f} (by {times['bound_by']}: {moved} bytes, "
          f"{flops} FLOP; H100 SXM peaks {H100_HBM_BYTES_S:.3g} B/s, "
          f"{H100_BF16_FLOP_S:.3g} FLOP/s)")
    return times


@torch.inference_mode()
def check_model_parity():
    """Same f32 weights on the card and on the CPU: logits within MODEL_TOL."""
    cfg = configs.get("stablelm-3b")
    cfg = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 131),
                           generator=torch.Generator().manual_seed(SEED + 1))
    prompt, max_seq = tokens[:, :128], 136
    worst = 0.0
    logits_c, caches_c = prefill(cfg, cpu_model, {"tokens": prompt}, max_seq)
    logits_g, caches_g = prefill(cfg, gpu_model, {"tokens": prompt.cuda()}, max_seq)
    steps = [("prefill", logits_c, logits_g)]
    for t in range(128, 131):
        tok = tokens[:, t:t + 1]
        logits_c, caches_c = decode_step(cfg, cpu_model, tok, caches_c)
        logits_g, caches_g = decode_step(cfg, gpu_model, tok.cuda(), caches_g)
        steps.append((f"decode {t}", logits_c, logits_g))
    for name, want, got in steps:
        err, ok = max_err(got.cpu(), want, MODEL_TOL, MODEL_TOL)
        worst = max(worst, err)
        print(f"model parity {name}: max|err| {err:.3e} (tol {MODEL_TOL})")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"card and CPU logits disagree at {name}")
    return worst


def serve_main_path() -> dict:
    cfg = configs.get("stablelm-3b")
    batch, prompt_len, new_tokens = 4, 512, 32
    max_seq = prompt_len + new_tokens + 1
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    rng = torch.Generator().manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=rng,
                            dtype=torch.int32)
    reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=new_tokens)
            for i in range(batch)]
    messages = []

    def progress(msg):
        messages.append(msg)
        print(msg, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve_requests(cfg, model, reqs, max_seq=max_seq, progress=progress,
                         device="cuda")
    counts = read_launches()
    launches = counts["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    if counts["flash_attention_bwd_dkv"] or counts["flash_attention_bwd_dq"]:
        raise AssertionError(f"backward kernels launched while serving: {counts}")
    if launches != cfg.num_layers:
        raise AssertionError(f"{launches} flash launches in the served run, "
                             f"expected {cfg.num_layers} (one per layer in prefill)")
    if any(len(out[i]) != new_tokens for i in range(batch)):
        raise AssertionError(f"token budgets not met: {[len(t) for t in out.values()]}")
    gen = torch.tensor([out[i] for i in range(batch)], dtype=torch.int32)
    if gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError("generated token id out of the vocabulary")

    # greedy agreement with a teacher-forced full forward (printed, not
    # asserted: bf16 near-ties can flip a greedy choice)
    full = torch.cat([prompts, gen], dim=1).cuda()
    with torch.inference_mode():
        logits = forward(cfg, model, {"tokens": full}, mode="train").logits
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits in the full forward")
    ref_tok = logits[:, prompt_len - 1:-1].argmax(dim=-1).cpu()
    agree = (ref_tok == gen).float().mean().item() * 100

    prefill_s = float(re.search(r"prefill: .* in ([0-9.]+)s", messages[0]).group(1))
    decode_tps = float(re.search(r"\(([0-9.]+) tok/s\)", messages[1]).group(1))
    print(f"serve stablelm-3b full width, {batch} x ({prompt_len} + {new_tokens}): "
          f"prefill {prefill_s:.3f} s = {batch * prompt_len / prefill_s:.1f} tok/s, "
          f"decode {decode_tps:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes), greedy agreement with full forward {agree:.1f}%, "
          f"flash launches {launches}")
    return {"flash_attention_fwd": launches}


def bwd_inputs(case, dtype):
    """q, k, v, do (MHA) and the forward's o, lse, dvec on the card."""
    b, h, sq, sk, d, causal, window = case
    gen = case_generator("bwd", case)
    shapes = ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d))
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in shapes)
    o, lse = flash_ref.attention_fwd_lse(q, k, v, scale=d ** -0.5, causal=causal,
                                         window=window)
    dvec = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, dvec


def check_bwd_kernels() -> dict:
    """B2 and B3 vs their plain versions on the card; returns their errors at
    the training shape in bf16 (the main path's dtype)."""
    errs = {}
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16)
             for c in BWD_CASES + [TRAIN_CASE, WIDE_BWD_CASE]]
    for case, dtype in cases:
        d, causal, window = case[4], case[5], case[6]
        q, k, v, do, o, lse, dvec = bwd_inputs(case, dtype)
        kw = {"scale": d ** -0.5, "causal": causal, "window": window}
        dk, dv = flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
        dq = flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
        torch.cuda.synchronize()
        want_dk, want_dv = flash_ref.attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
        want_dq = flash_ref.attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
        tol = BWD_TOL[dtype]
        results = {name: max_err(got, want, tol, tol) for name, got, want in
                   (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
        line = (f"flash bwd {case} {str(dtype)[6:]} inputs {input_hash(q, k, v, do)}: "
                + ", ".join(f"{n} max|err| {e:.3e}" for n, (e, _) in results.items())
                + f" (tol {tol} + {tol}|want|)")
        print(line)
        if not all(ok for _, ok in results.values()) or dq.shape != q.shape \
                or dk.shape != k.shape or dv.shape != v.shape:
            raise AssertionError(f"backward kernel disagrees with its plain version: {line}")
        if case == TRAIN_CASE and dtype == torch.bfloat16:
            errs = {"flash_attention_bwd_dkv": max(results["dk"][0], results["dv"][0]),
                    "flash_attention_bwd_dq": results["dq"][0]}
    # GQA through the op (K/V expanded, dK/dV group-summed): card vs CPU, f32,
    # on several seeds
    b, hq, hkv, sq, sk, d, causal, window = GQA_CASE
    tol = BWD_TOL[torch.float32]
    for seed in GQA_SEEDS:
        gen = case_generator("gqa", GQA_CASE, seed)
        q, k, v, g = (torch.randn(s, generator=gen, device="cuda") for s in
                      ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)))
        grads = []
        for dev in ("cuda", "cuda", "cpu"):
            tq, tk, tv = (t.to(dev).requires_grad_() for t in (q, k, v))
            out = flash_ops.flash_attention(tq, tk, tv, causal, window)
            grads.append(torch.autograd.grad((out * g.to(dev)).sum(), (tq, tk, tv)))
        results = {}
        for name, got, again, want in zip(("dq", "dk", "dv"), *grads, strict=True):
            results[name] = max_err(got.cpu(), want, tol, tol)
            # no atomics and a fixed order of every sum: a second run is bit-identical
            if not torch.equal(got, again):
                raise AssertionError(f"GQA gradient {name} differs between two runs "
                                     f"on the card (seed {seed})")
        line = (f"flash op grad GQA {GQA_CASE} f32 card vs cpu, seed {seed} inputs "
                f"{input_hash(q, k, v, g)}: "
                + ", ".join(f"{n} max|err| {e:.3e}" for n, (e, _) in results.items())
                + f" (tol {tol} + {tol}|want|)")
        print(line)
        if not all(ok for _, ok in results.values()):
            raise AssertionError(f"GQA gradient disagrees between card and CPU: {line}")
    # the same at the training shape, kernel by kernel
    d, causal, window = TRAIN_CASE[4], TRAIN_CASE[5], TRAIN_CASE[6]
    args = bwd_inputs(TRAIN_CASE, torch.bfloat16)
    q, k, v, do, _, lse, dvec = args
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    for fn in (flash_bwd.flash_attention_bwd_dkv, flash_bwd.flash_attention_bwd_dq):
        first, second = (fn(q, k, v, do, lse, dvec, **kw) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second, strict=True)):
            raise AssertionError(f"{fn.__name__} differs between two runs on the card")
    print("flash op and bwd kernels: two runs on the card are bit-identical")
    return errs


def time_bwd() -> dict:
    """B2 and B3 at the training shape, bf16: kernel, plain, library, bound."""
    b, h, sq, sk, d, causal, window = TRAIN_CASE
    q, k, v, do, o, lse, dvec = bwd_inputs(TRAIN_CASE, torch.bfloat16)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    # the library yardstick: the backward of PyTorch's fused attention on the
    # same inputs (dq, dk and dv together), timed only for comparison
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lout = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal, scale=d ** -0.5)
    fns = {
        "flash_attention_bwd_dkv": {
            "ms": lambda: flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw),
            "plain_ms": lambda: flash_ref.attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)},
        "flash_attention_bwd_dq": {
            "ms": lambda: flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw),
            "plain_ms": lambda: flash_ref.attention_bwd_dq(q, k, v, do, lse, dvec, **kw)},
    }
    library = lambda: torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True)  # noqa: E731
    runs = {(name, key): [] for name, f in fns.items() for key in f}
    runs["library"] = []
    for _ in range(3):  # in turns, median of three
        for (name, key) in list(runs)[:-1]:
            runs[(name, key)].append(time_ms(fns[name][key], iters=10))
        runs["library"].append(time_ms(library, iters=10))
    library_ms = sorted(runs["library"])[1]
    # bound: inputs read once and outputs written once; the operations on the
    # live (query, key) pairs: B2 QK^T, dO V^T, P^T dO, dS^T Q (8 D each),
    # B3 QK^T, dO V^T, dS K (6 D each)
    elem = q.element_size()
    live = int(flash_ref.attention_mask(sq, sk, causal, window).sum()) * b * h
    reads = (q.numel() + k.numel() + v.numel() + do.numel()) * elem + 2 * lse.numel() * 4
    work = {"flash_attention_bwd_dkv": (reads + 2 * k.numel() * elem, 8 * d * live),
            "flash_attention_bwd_dq": (reads + q.numel() * elem, 6 * d * live)}
    times = {}
    for name in fns:
        moved, flops = work[name]
        bound_ms, by = bound(moved, flops)
        times[name] = {"ms": sorted(runs[(name, "ms")])[1],
                       "plain_ms": sorted(runs[(name, "plain_ms")])[1],
                       "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
        t = times[name]
        print(f"{name} timing {TRAIN_CASE} bf16: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {library_ms:.4f} (SDPA backward, dq dk dv) "
              f"bound_ms {bound_ms:.4f} (by {by}: {moved} bytes, {flops} FLOP)")
    return times


def check_train_parity():
    """Same f32 weights on the card (B1, B2, B3) and on the CPU (plain
    versions): loss and every gradient within the stated bounds."""
    cfg = dataclasses.replace(configs.get("stablelm-3b"), num_layers=2, dtype="float32")
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    data = SyntheticLM(cfg.vocab_size, 128, seed=SEED)
    batch = {k: torch.from_numpy(v) for k, v in data.global_batch(0, 2, 1).items()}
    losses = []
    for model in (gpu_model, cpu_model):
        loss, _ = loss_fn(cfg, model, {k: v.to(model.device) for k, v in batch.items()})
        loss.backward()
        losses.append(loss.item())
    print(f"train parity loss card {losses[0]:.7f} cpu {losses[1]:.7f}")
    if not math.isclose(losses[0], losses[1], rel_tol=TRAIN_LOSS_RTOL):
        raise AssertionError(f"card and CPU losses differ beyond rtol {TRAIN_LOSS_RTOL}")
    worst = 0.0
    for (name, pg), (_, pc) in zip(gpu_model.named_parameters(), cpu_model.named_parameters(),
                                   strict=True):
        rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not rel <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"gradient {name}: card vs CPU relative error {rel:.3e}")
    print(f"train parity gradients: worst per-leaf ||card - cpu|| / ||cpu|| {worst:.3e} "
          f"(tol {TRAIN_GRAD_RTOL}) over {len(list(cpu_model.parameters()))} leaves")
    return worst


LAUNCH_COUNTERS = {
    "flash_attention_fwd": flash_kernel.flash_attention_fwd_lse,
    "flash_attention_bwd_dkv": flash_bwd.flash_attention_bwd_dkv,
    "flash_attention_bwd_dq": flash_bwd.flash_attention_bwd_dq,
}


def reset_launches() -> None:
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def train_main_path() -> tuple[dict, list[float]]:
    """The main path: full-config stablelm-3b trains TRAIN_STEPS steps.
    Returns the launch counts of the run and its losses."""
    b, _, seq = TRAIN_CASE[0], TRAIN_CASE[1], TRAIN_CASE[2]
    tc = train_mod.TrainConfig(arch="stablelm-3b", scale="full", steps=TRAIN_STEPS,
                               batch_size=b, seq_len=seq, grad_sync="bridge", seed=SEED)
    cfg = train_mod.model_config(tc)
    if (cfg.dtype, cfg.remat, cfg.remat_policy, cfg.num_layers) != ("bfloat16", True, "full", 32):
        raise AssertionError(f"not the full config: {cfg}")
    lines = []

    def progress(msg):
        lines.append(msg)
        print(msg, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, _, losses = train_mod.train(tc, progress=progress, device="cuda")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {"flash_attention_fwd": 2 * cfg.num_layers,   # forward + remat recompute
                "flash_attention_bwd_dkv": cfg.num_layers,
                "flash_attention_bwd_dq": cfg.num_layers}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"launches in the training run {launches}, expected {want}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    dts = [float(re.search(r"dt ([0-9.]+)s", line).group(1)) for line in lines]
    timed = dts[1:]
    step_s = sum(timed) / len(timed)
    print(f"train stablelm-3b full config (bf16, remat full, grad_sync bridge, 1 rank), "
          f"batch {b} x {seq}: losses {losses}, warm-up step {dts[0]:.4f} s, timed steps "
          f"{timed} s, mean {step_s:.4f} s = {b * seq / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes), launches {launches} "
          f"(per step {per_step})")
    return launches, losses


# --- multi-card phase ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multi_card(n: int, main_losses: list[float]) -> dict:
    """Start n ranks of this script (--rank) with torchrun and return rank 0's
    results.  Their first training losses must match the main path's: the
    global batch does not depend on the world size."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), __file__, "--rank"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:  # stop torchrun and every rank it started
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    print(out, end="")
    if proc.returncode != 0:
        raise AssertionError(f"multi-card ranks exited {proc.returncode}")
    res = json.loads([ln for ln in out.splitlines() if ln.startswith('{"ranks"')][-1])
    want = main_losses[:MULTI_STEPS]
    for mode, got in res["train_losses"].items():
        if not all(math.isclose(a, b, rel_tol=LOSS_RTOL) for a, b in zip(got, want, strict=True)):
            raise AssertionError(f"{n}-rank {mode} losses {got} differ from the one-rank "
                                 f"main path's {want} beyond rtol {LOSS_RTOL}")
    print(f"multi-card train: {n}-rank gspmd and bridge losses match the one-rank main "
          f"path's {want} (rtol {LOSS_RTOL})")
    return res


def _rank_main() -> None:
    """One NCCL rank of the multi-card phase, started by torchrun."""
    import torch.distributed as dist

    from repro_torch.collectives import (bridge_all_reduce, bruck_all_reduce,
                                         gradient_sync_plan, ring_all_reduce, shift)
    from repro_torch.core.cost_model import H100_NVLINK

    dist.init_process_group("nccl")
    n, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else (lambda *a: None)
    out = {"ranks": n}

    def host_ms(fn, iters):
        fn()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        return (time.perf_counter() - t0) / iters * 1e3

    try:
        gen = torch.Generator(device=dev).manual_seed(SEED + rank)
        for mb in MULTI_SIZES_MB:
            x = torch.randn(mb * 2**20 // 4, generator=gen, device=dev)
            want = x.clone()
            dist.all_reduce(want)
            impls = {"library": lambda x=x: dist.all_reduce(x.clone()),
                     "bruck": lambda x=x: bruck_all_reduce(x),
                     "ring": lambda x=x: ring_all_reduce(x),
                     "bridge": lambda x=x: bridge_all_reduce(x, H100_NVLINK)}
            for name in ("bruck", "ring", "bridge"):
                got = impls[name]()
                err = (got - want).abs().max().item()
                if not err <= 1e-5 + 1e-5 * want.abs().max().item():
                    raise AssertionError(f"{name} all-reduce {mb} MB: max|err| {err}")
            plan = gradient_sync_plan(n, x.numel() * 4, H100_NVLINK)
            ms = {name: host_ms(fn, 5) for name, fn in impls.items()}
            out[f"allreduce_{mb}MB_ms"] = ms
            say(f"multi-card all-reduce {mb} MB f32 on {n} ranks (host clock, ms): {ms}; "
                f"gradient_sync_plan picks {plan.impl} (bridge_all_reduce is always Bruck)")
        # shift latency at one f32 element, offsets 1 and 2 in turns, nine rounds
        # of 200 each, on the host clock and on CUDA events of the current stream
        # (which waits for NCCL's); alpha_h := t(2) - t(1), alpha_s := t(1) - alpha_h
        tiny = torch.zeros(1, device=dev)
        rounds = {(clock, off): [] for clock in ("host", "event") for off in (1, 2)}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(9):
            for off in (1, 2):
                fn = lambda off=off: shift(tiny, off % n or 1)  # noqa: E731
                rounds[("host", off)].append(host_ms(fn, 200))
                dist.barrier()
                torch.cuda.synchronize()
                start.record()
                for _ in range(200):
                    fn()
                end.record()
                torch.cuda.synchronize()
                rounds[("event", off)].append(start.elapsed_time(end) / 200)
        shift_ms = {}
        for clock in ("host", "event"):
            t1, t2 = (sorted(rounds[(clock, off)])[4] for off in (1, 2))
            shift_ms[clock] = {"offset1": t1, "offset2": t2,
                               "alpha_s_s": (2 * t1 - t2) * 1e-3, "alpha_h_s": (t2 - t1) * 1e-3,
                               "rounds1": rounds[(clock, 1)], "rounds2": rounds[(clock, 2)]}
            say(f"multi-card shift latency (1 element, {clock}, median of 9 x 200): offset 1 "
                f"{t1:.4f} ms (rounds {min(rounds[(clock, 1)]):.4f}-"
                f"{max(rounds[(clock, 1)]):.4f}), offset 2 {t2:.4f} ms -> alpha_s "
                f"{shift_ms[clock]['alpha_s_s']:.3e} s, alpha_h "
                f"{shift_ms[clock]['alpha_h_s']:.3e} s")
        out["shift_ms"] = shift_ms
        # the full config trains MULTI_STEPS steps through train() per mode
        b, _, seq = TRAIN_CASE[:3]
        losses, step_s = {}, {}
        for mode in ("gspmd", "bridge"):
            tc = train_mod.TrainConfig(arch="stablelm-3b", scale="full", steps=MULTI_STEPS,
                                       batch_size=b, seq_len=seq, grad_sync=mode, seed=SEED)
            lines = []
            model, opt_state, losses[mode] = train_mod.train(tc, progress=lines.append,
                                                             device="cuda")
            step_s[mode] = [float(re.search(r"dt ([0-9.]+)s", ln).group(1)) for ln in lines]
            if mode == "bridge":
                payload = sum(p.numel() * p.element_size() for p in model.parameters())
                plan = gradient_sync_plan(n, payload, H100_NVLINK)
                out["train_plan"] = {"payload_bytes": payload, "impl": plan.impl,
                                     "predicted_s": plan.predicted_time,
                                     "alternatives_s": plan.alternatives}
                say(f"multi-card train: bridge syncs {payload} bytes of gradients a step "
                    f"with {plan.impl} (predicted {plan.predicted_time:.4e} s; "
                    f"alternatives {plan.alternatives})")
            del model, opt_state  # before the next mode's weights and moments
            gc.collect()
            torch.cuda.empty_cache()
        out["train_losses"], out["train_step_s"] = losses, step_s
        say(f"multi-card train stablelm-3b full config, {n} ranks, global batch {b} x {seq}: "
            f"gspmd {losses['gspmd']} (steps {step_s['gspmd']} s), bridge {losses['bridge']} "
            f"(steps {step_s['bridge']} s) (rtol {LOSS_RTOL})")
        if not all(math.isclose(a, c, rel_tol=LOSS_RTOL)
                   for a, c in zip(losses["bridge"], losses["gspmd"], strict=True)):
            raise AssertionError("bridge and gspmd losses differ")
        say(json.dumps(out))
    finally:
        dist.destroy_process_group()


def main() -> None:
    if sys.argv[1:] == ["--rank"]:  # one rank of the multi-card phase
        _rank_main()
        return
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    smi = nvidia_smi()
    count = torch.cuda.device_count()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | devices {count}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("2 build")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase("3 kernels vs plain")
    fwd_errs = check_kernels()
    bwd_errs = check_bwd_kernels()
    phase("4 kernel timing")
    fwd_times = {case: time_flash(case) for case in (TRAIN_FWD_CASE, SERVE_CASE)}
    bwd_times = time_bwd()
    phase("5 model parity card vs cpu")
    check_model_parity()
    phase("6 train parity card vs cpu")
    check_train_parity()
    phase("7 serve")
    serve_launches = serve_main_path()
    phase("8 train (main path)")
    train_launches, train_losses = train_main_path()
    phase("9 multi-card")
    if count >= 2:
        gc.collect()
        torch.cuda.empty_cache()  # rank 0 shares this card
        multi_card(min(4, count), train_losses)
    else:
        print(f"multi-card phase: not run ({count} device)")

    sources = {"flash_attention_fwd": ("flash_attention_fwd.cu", "kernel.py:35"),
               "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", "kernel_bwd.py:48"),
               "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "kernel_bwd.py:92")}
    # one entry per kernel and path: launches of that path's run, error and
    # times at the shape that path gives the kernel
    entries = [("train", "flash_attention_fwd", TRAIN_FWD_CASE, train_launches,
                fwd_errs[TRAIN_FWD_CASE], fwd_times[TRAIN_FWD_CASE]),
               *(("train", name, TRAIN_CASE, train_launches, bwd_errs[name], bwd_times[name])
                 for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")),
               ("serve", "flash_attention_fwd", SERVE_CASE, serve_launches,
                fwd_errs[SERVE_CASE], fwd_times[SERVE_CASE])]
    print(f"launches: serve {serve_launches}, train {train_launches}")
    kernels = [{
        "name": name,
        "path": path,
        "shape": list(case),
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources[name][0]}",
        "replaces": f"src/repro/kernels/flash_attention/{sources[name][1]}",
        "launches": launches[name],
        "max_abs_err": err,
        **times,
    } for path, name, case, launches, err, times in entries]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

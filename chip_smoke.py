#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device  - require CUDA; print the card's name and power limit; TF32 off.
  2. build   - build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc.
  3. kernels - every kernel against its plain PyTorch version on the card, at
               the reference test shapes and at the serving shape.
  4. timing  - the kernel, its plain version and one PyTorch library call at
               the serving shape (CUDA events), beside the card's bound.
  5. parity  - stablelm-3b at full width cut to 4 layers, f32: the same weights
               on the card (kernel) and on the CPU (plain version) give the
               same prefill and decode logits.
  6. serve   - the main path: stablelm-3b at its full published config (32
               layers, bf16, random weights from a seed) answers 4 requests of
               512-token prompts with 32 new tokens each through
               `repro_torch.launch.serve.serve_requests`; the kernel launch
               counts of that run are read and checked.
Then it prints the kernels' JSON line, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402  (fails outside a checkout)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch.serve import Request, serve_requests  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, prefill  # noqa: E402

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
# ... the serving shape (stablelm-3b prefill: 4 prompts of 512, 32 heads of 80)
# and gemma3's head dim 256 with GQA and a sliding window.
SERVE_CASE = (4, 32, 32, 512, 512, 80, True, None)
WIDE_CASE = (1, 8, 4, 300, 300, 256, True, 100)
TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}  # tests/test_kernels.py bounds
LSE_TOL = {torch.float32: 1e-5,  # f32 lse, same source
           # both sides compute lse in f32 from the same bf16 inputs
           torch.bfloat16: 1e-3}
MODEL_TOL = 2e-3        # prefill/decode bound of tests/test_models_smoke.py
SEED = 0


def phase(name: str):
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def flash_inputs(case, dtype, generator):
    b, hq, hkv, sq, sk, d = case[:6]
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    return [torch.randn(s, generator=generator, device="cuda").to(dtype) for s in shapes]


def max_err(got, want, atol, rtol):
    """(max abs error, whether |got - want| <= atol + rtol |want| everywhere)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def check_kernels(generator) -> float:
    """Kernel vs plain version on the card; returns the error at the serving shape."""
    serve_err = None
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16) for c in FLASH_CASES]
    cases += [(SERVE_CASE, torch.bfloat16), (SERVE_CASE, torch.float32),
              (WIDE_CASE, torch.bfloat16), (WIDE_CASE, torch.float32)]
    for case, dtype in cases:
        d, causal, window = case[5], case[6], case[7]
        q, k, v = flash_inputs(case, dtype, generator)
        out, lse = flash_kernel.flash_attention_fwd_lse(
            q, k, v, scale=d ** -0.5, causal=causal, window=window)
        torch.cuda.synchronize()
        want_out, want_lse = flash_ref.attention_fwd_lse(
            q, k, v, scale=d ** -0.5, causal=causal, window=window)
        err, ok = max_err(out, want_out, TOL[dtype], TOL[dtype])
        lse_err, lse_ok = max_err(lse, want_lse, LSE_TOL[dtype], LSE_TOL[dtype])
        ok = ok and lse_ok
        line = (f"flash {case} {str(dtype)[6:]}: out max|err| {err:.3e} "
                f"(tol {TOL[dtype]}), lse max|err| {lse_err:.3e} (tol {LSE_TOL[dtype]})")
        print(line)
        if not ok or out.shape != q.shape or lse.shape != q.shape[:3]:
            raise AssertionError(f"kernel disagrees with its plain version: {line}")
        if case == SERVE_CASE and dtype == torch.bfloat16:  # the main path's dtype
            serve_err = err
    return serve_err


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


def time_flash(generator) -> dict:
    b, hq, hkv, sq, sk, d, causal, window = SERVE_CASE
    q, k, v = flash_inputs(SERVE_CASE, torch.bfloat16, generator)
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
    print(f"flash timing {SERVE_CASE} bf16: kernel_ms {times['ms']:.4f} "
          f"plain_ms {times['plain_ms']:.4f} library_ms {times['library_ms']:.4f} "
          f"bound_ms {times['bound_ms']:.4f} (by {times['bound_by']}: {moved} bytes, "
          f"{flops} FLOP; H100 SXM peaks {H100_HBM_BYTES_S:.3g} B/s, "
          f"{H100_BF16_FLOP_S:.3g} FLOP/s)")
    return times


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
    flash_kernel.flash_attention_fwd_lse.launches = 0
    out = serve_requests(cfg, model, reqs, max_seq=max_seq, progress=progress,
                         device="cuda")
    launches = flash_kernel.flash_attention_fwd_lse.launches
    peak = torch.cuda.max_memory_allocated()
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


def main() -> None:
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    smi = nvidia_smi()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    generator = torch.Generator(device="cuda").manual_seed(SEED)
    phase("3 kernels vs plain")
    serve_err = check_kernels(generator)
    phase("4 kernel timing")
    times = time_flash(generator)
    phase("5 model parity card vs cpu")
    check_model_parity()
    phase("6 serve (main path)")
    launches = serve_main_path()

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:35",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": serve_err,
        **times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

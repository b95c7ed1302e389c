#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py     # one card; with two or more, phase 9 runs too

Phases, in order; any failure raises and the script exits non-zero:
  1. device  - require CUDA; print the card's name and power limit; TF32 off.
  2. build   - build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
               print each kernel's registers and spills from ptxas.
  3. kernels - every kernel against its plain PyTorch version on the card: the
               forward B1 at the reference test shapes, the serving shapes
               (stablelm-3b; recurrentgemma-9b's local layers; qwen3-moe's
               GQA 16:1 at D = 128; minicpm3-4b's MLA at D = 96 with V of
               64, padded by the op; whisper-base's bidirectional encoder,
               its cross attention in prefill and in decode (one query) and
               its self attention; internvl2-26b's GQA 6:1 over 1536
               positions) and the training shape, and ragged
               shapes; the backward B2 (dK/dV)
               and B3 (dQ) at the reference gradient shapes, the training
               shape, ragged shapes, a GQA case on several seeds and a
               D = 256 window case (B1, B2 and B3 in bf16 run their
               tensor-core variants, in f32 their CUDA-core ones); the
               recurrences B4 (RG-LRU) and B5 (WKV-6) in f32 and bf16 at the
               reference test shapes, from a nonzero initial state, at T = 1,
               at the serving prefill and decode shapes, B4 at a ragged T over
               many stages of its ring (2, 1100, 4096) and at an odd D (its
               one-element copies and one-lane step threads), B5 at a ragged
               T over several chunks and at extreme decay in both dtypes
               (T = 1 runs B4's and B5's step kernels, T > 1 B4's ring and,
               in bf16, B5's two-pass design, each call checked by its
               counters).  B4 in f32 equals its plain version bit for bit.
               Every bf16 output of B1 is also held to its own rows' scale
               (BF16_ROW_TOL), which TOL's 5e-2 is not at whisper's shapes.
               B2, B3, B4's ring and B5's two-pass design are bit-identical
               over two runs.  The recurrences' backward B4' (RG-LRU) and
               B5' (WKV-6) against their plain reverse loops in f32 and bf16:
               at the reference test shapes, from a nonzero h0 / s0 with a
               nonzero cotangent on h_last / s_last, at the training shapes
               (B4' (8, 512, 4096) f32, B5' (8, 40, 512, 64, 64) bf16 from
               the forward's chunk-entry states), at a ragged T (B4' 1100,
               B5' 200) and at extreme decay (a = e^-20, log_w = -20); B4'
               in f32 equals its plain version bit for bit, every bf16 B5'
               check takes the chunked design (`launches_chunked`), and every
               B4' and B5' check gives the same bits in two runs.  B1, B2,
               B3, B4 and B5 are also checked at the training shapes of
               recurrentgemma-9b (D = 256 under MQA) and rwkv6-3b.  Each
               check draws its inputs from a generator of its own and
               prints their hash.
  4. timing  - each kernel, its plain version and one PyTorch library call
               (CUDA events around queued calls: `ms`, where a wrapper's host
               work counts wherever it outlasts its kernel), and each kernel
               again with the card held busy while its launches are queued
               (`device_ms`: device time only), beside the card's bound, at
               the shape each path gives it: B1 at the serving
               shapes (qwen3-moe's and the new ones of phase 3 included; MLA's
               through the op, padding included, and its kernel alone on V
               padded beforehand) and the training shape, B2 and B3 at the training
               shape, B4 and B5 at the serving prefill and decode shapes,
               and at the training shapes of recurrentgemma-9b and rwkv6-3b
               B1, B2, B3, B4, B5, B4' and B5' (B4' and B5' have no library
               call: B4' is shown beside a torch.add moving its bytes, B5''s
               chunked design's FLOP beside its bound, priced at the TF32
               peak).
               No single PyTorch call computes either recurrence over T, so
               their prefill library time is null; B4's decode step is
               torch.addcmul(b, a, h0), checked against the plain version
               and timed both ways as its library time.  The attention
               yardstick is timed, both ways,
               under each SDPA backend that runs at the shape (flash, cuDNN,
               efficient); the fastest is the library time (`library_ms`,
               `library_device_ms`), and its backend is recorded.
  5. parity  - at full width, f32, depth cut: stablelm-3b (4 layers),
               recurrentgemma-9b (one pattern period: rglru, rglru, local),
               rwkv6-3b (2 layers), qwen3-moe-235b-a22b (1 layer, ~15 GB),
               minicpm3-4b (2 layers), whisper-base whole (6 + 6 layers,
               1500 frames) and internvl2-26b (1 layer, 64 patches):
               the same weights on the card (kernels) and on the CPU (plain
               versions) give the same prefill and decode logits; for the MoE
               arch it also prints how many (token, choice) routing decisions
               (expert and kept or dropped) agree between card and CPU, and
               the top-k probability gap of any token that differs.
  6. train parity - stablelm-3b and rwkv6-3b at full width cut to 2 layers,
               and recurrentgemma-9b cut to its two RG-LRU layers, f32, 2 x
               128 tokens: the same weights on the card (B1, B2, B3; B4, B4';
               B5, B5') and on the CPU (plain versions) give the same loss and
               gradients.
  7. serve   - stablelm-3b, recurrentgemma-9b, rwkv6-3b and minicpm3-4b, each
               at its full published config, and qwen3-moe-235b-a22b at its
               full width cut to 8 of its 94 layers (bf16, random weights
               from a seed), answer 4 requests of 512-token prompts with 32
               new tokens each through
               `repro_torch.launch.serve.serve_requests`, one model at a
               time; whisper-base (6 + 6 layers, 1500 frames, 64-token
               prompts) and internvl2-26b (48 layers, 1024 patches before
               512-token prompts), whose inputs that driver does not take,
               go through the entry points `prefill` and `decode_step` in
               the same loop;
               the kernel launch counts of each run, in prefill and in decode,
               are read and checked (B1 once per attention or MLA layer in
               prefill, whisper's once per encoder layer and per cross
               attention in prefill and in every decode step, each in the
               tensor-core variant; B4 / B5 once per recurrent
               layer in prefill and in every decode step; every prefill call
               of B4 in the ring design and of B5 in the two-pass design,
               every decode call of both in the step kernel).  Then one more
               decode step of each runs under torch.profiler (device ms, the
               device's idle share, host reads of device values, the top ops
               by device time), and the MoE arch's FFN is timed at the
               prefill and decode shapes: whole, its expert products, and
               its dispatch and combine products, beside its bound.
  8. train (the main path) - stablelm-3b at its full published config, then
               rwkv6-3b whole (32 layers) and recurrentgemma-9b at full width
               cut to one pattern period (rglru, rglru, local: 3 of 38
               layers; the whole model's weights, gradients and moments do
               not fit one card), each bf16, full remat, batch 8 x 512,
               grad_sync "bridge": 1 warm-up step and 3 timed steps through
               `repro_torch.launch.train.train`; the launch counts of each
               run are read and checked per step (stablelm-3b B1 64, B2 32,
               B3 32; rwkv6-3b B5 64, all two-pass, and B5' 32, all chunked
               and from the forward's states; recurrentgemma-9b B4 4, all
               ring, B4' 2, B1
               2, B2 1, B3 1; every B1, B2 and B3 launch in the tensor-core
               variant).
  9. multi-card - only with two or more cards: torchrun starts min(4, count)
               NCCL ranks (this script with --rank), which run the Bruck, ring
               and Bridge all-reduce against dist.all_reduce and the Bruck
               all-to-all against dist.all_to_all_single (bit-exact), timing
               each at 1 MB and 256 MB a rank, run the compressed all-reduce's
               gates, time the shift latencies behind the H100_NVLINK cost
               model, and train the full config 2 steps through `train()`
               with grad_sync "gspmd", "bridge" and "bridge-compressed"; the
               first two's losses must agree with each other and with the
               main path's, the last's be finite and end below 1.5 x its
               first.  With one card it says that it did not run.
 10. fabric playback - the certified tape playback B6 (float64) against
               its plain version on the card, bit for bit and over two runs:
               the deduped a2a / rs / ag candidate sets at n in {6, 12, 48,
               96, 97} and r in {2, 3} with seeded payloads and a
               zero-payload lane, C in {1, 4, 8}, delta in {0, 1 ms}; the
               layout's own points (`launch_plan`): n = 1536 on 1, 2, 3,
               4, 8 and 16 CTAs, n = 97 with its trains in registers,
               shared and device memory on 1 and 5 CTAs (C = 3, 8, 20;
               registers at 8), the plan's steps from one CTA to two (n =
               1024 / 1025 at C = 16, 2048 / 2049 at 8, 4096 / 4097 at 2;
               n = 1536 at C = 3 in shared memory), offsets far outside
               [0, n) and hop counts of 0 and below; then the reference's
               sim_bench tiers, built as its `_jax_lanes`
               builds them (n = 1536 x 256 lanes, C = 4, hop cap 300; n =
               8192 x 64, C = 2, cap 400; n = 32768 x 32, C = 2, cap 600):
               B6 against its plain version, and the path
               `batch_run(backend="torch")` with B6's launches counted (at
               n = 1536 beside `backend="numpy"`, bit for bit on node_done,
               step_done and completion, every lane certified), each
               completion checksum printed beside the one
               BENCH_sim_scale.json records; the planner's ocs-sim path,
               the default `Planner()` (it verifies each plan on the host,
               and "auto" plays the candidates on the card) for a2a, rs and
               ag at n = 1536 and 32768, in turns with `Planner(verify=False)`
               and at n = 1536 with `sim_backend="numpy"` (the same plans,
               `to_dict()` with predicted times and the alternatives' scores,
               every way), B6's launches counted, the plan latency both ways
               and `verify_plan` alone (the verifier's caches cleared before
               each), B6 against its plain version on the a2a set at both; B6 timed (`ms`, `device_ms`, the plain version
               on the card) at each tier's and the planner's shapes, with
               its layout (CTAs a lane, threads, where the trains live, how
               many clusters the card holds at once), beside its bound (the
               larger of the bytes at the HBM rate, the FP64 work at the
               FP64 peak and the longest lane's serial chain); and the
               crossover of whole `batch_run` calls, NumPy against the
               card, on the candidate sets from n = 2 to 384 (C = 8),
               beside `batchsim._AUTO_MIN_WORK`.
 11. checkpointed training restart, workloads - stablelm-3b and rwkv6-3b at
               full width cut to 2 layers (bf16, full remat, grad_sync
               "bridge", 8 x 512) through `train()`: 4 straight steps; 2
               steps that save a checkpoint (`checkpoint_every=2`) into a
               temporary directory; a fresh `train()` on that directory that
               resumes and runs steps 3-4, its launches counted a step
               (stablelm-3b B1 4, B2 2, B3 2, tensor-core; rwkv6-3b B5 4
               two-pass, B5' 2 chunked); the resumed losses equal the
               straight run's at rtol 1e-4, their bits and the final
               parameters' compared and printed, with the checkpoint's bytes
               and its save and restore seconds; the directory is deleted.
               Then the workloads (NumPy on the host, as the reference's): one
               grid point of each of BENCH_trace.json, BENCH_online.json,
               BENCH_faults.json and BENCH_tenancy.json re-derived by the port
               and held to the committed row at 1e-12 relative, with the
               benches' gates there (carryover <= cold and <= static, online
               within the regret bound, recovery <= restart and bit-identical,
               port-partition isolation 1.0), and the plan service answering
               online_bench's storm twice (hits, misses and windows the
               committed row's; hot plans/s printed).
Then it prints the kernels' JSON line (one entry per kernel and path, each
with the launches of that path's run and the numbers of the shape that path
gives it; a served model's prefill and decode are two paths, each fabric
tier and the planner's verified scoring at n = 1536 and 32768 are B6's
paths, and phase 11's resumed runs are paths of B1, B2, B3, B5 and B5'), the
card's name and power limit, and as its last line {"ok": true, "device":
{...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402  (fails outside a checkout)
from repro_torch.analysis import clear_verifier_caches, verify_plan  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.core import PAPER_DEFAULT, FabricSim, batchsim, schedules  # noqa: E402
from repro_torch.core.faults import FaultSpec, FaultTimeline  # noqa: E402
from repro_torch.core.jsonio import FabricKind, SharingMode  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.playback import kernel as playback_kernel  # noqa: E402
from repro_torch.kernels.playback import ref as playback_ref  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as lru_kernel  # noqa: E402
from repro_torch.kernels.rg_lru import ref as lru_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, serve_requests  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, prefill  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.planner import Planner, PlanRequest  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core FLOP/s and f32 FLOP/s outside the tensor cores.  They
# assume the full 700 W power limit.
H100_HBM_BYTES_S = 3.35e12
H100_BF16_FLOP_S = 989e12
H100_F32_FLOP_S = 67e12
H100_TF32_FLOP_S = 495e12
PEAK_FLOP_S = {torch.bfloat16: H100_BF16_FLOP_S, torch.float32: H100_F32_FLOP_S}

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
# recurrentgemma-9b's local layers in prefill: 16 query heads of 256, MQA, window 2048
GRIFFIN_CASE = (4, 16, 1, 512, 512, 256, True, 2048)
# qwen3-moe-235b-a22b's prefill: 64 query heads of 128 on 4 KV heads (GQA 16:1)
QWEN_CASE = (4, 64, 4, 512, 512, 128, True, None)
# whisper-base serving 4 requests (8 heads of 64): the encoder over 1500
# frames (bidirectional), cross attention of the 64-token prompts and of one
# decode query against the 1500 frames (no mask), and the decoder's causal
# self attention in prefill
WHISPER_ENC_CASE = (4, 8, 8, 1500, 1500, 64, False, None)
WHISPER_CROSS_CASE = (4, 8, 8, 64, 1500, 64, False, None)
WHISPER_CROSS_DECODE = (4, 8, 8, 1, 1500, 64, False, None)
WHISPER_SELF_CASE = (4, 8, 8, 64, 64, 64, True, None)
# minicpm3-4b's MLA prefill: 40 heads, query/key head 96 (nope 64 + rope 32)
# and value head 64 (the ninth field), scale 96^-0.5, through the op, which
# pads V to 96
MLA_CASE = (4, 40, 40, 512, 512, 96, True, None, 64)
# internvl2-26b's prefill: 1024 patches + 512 tokens, 48 heads of 128 on 8 KV
# heads (GQA 6:1)
INTERNVL_CASE = (4, 48, 8, 1536, 1536, 128, True, None)
# recurrentgemma-9b training 8 x 512: its local layers' MQA at D = 256
GRIFFIN_TRAIN_CASE = (8, 16, 1, 512, 512, 256, True, 2048)
NEW_CASES = (WHISPER_ENC_CASE, WHISPER_CROSS_CASE, WHISPER_CROSS_DECODE, WHISPER_SELF_CASE,
             MLA_CASE, INTERNVL_CASE)
# ragged Sq and Sk (not multiples of 16 or 64): Sq < Sk under GQA, and MQA
# with a window
RAGGED_CASES = [(1, 4, 2, 72, 300, 80, True, None), (2, 4, 1, 300, 300, 80, True, 100)]
TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}  # tests/test_kernels.py bounds
LSE_TOL = {torch.float32: 1e-5,  # f32 lse, same source
           # both sides compute lse in f32 from the same bf16 inputs
           torch.bfloat16: 1e-3}
# bf16 outputs are held a second time to their own scale: |err| <= BF16_STEP
# |want| + BF16_ROW_TOL rms(want's row).  TOL[bf16] alone is about the size of
# whisper's outputs (rms 0.04 over 1500 keys), so it can pass a P.V that lost
# the keys of the last partial tile (3e-2 at a decode query).  The first term
# is one bf16 step of the value (both sides round an f32 result to bf16); the
# second the kernel's rounding of P to bf16 before P.V, which the emulation in
# tests/test_torch_flash_attention.py keeps below a hundredth of the row's rms.
BF16_STEP = 2.0 ** -7
BF16_ROW_TOL = 2e-2
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
# recurrentgemma-9b's training shape, its one K/V head expanded to 16
GRIFFIN_BWD_CASE = (8, 16, 512, 512, 256, True, 2048)
WIDE_BWD_CASE = (1, 8, 300, 300, 256, True, 100)
GQA_CASE = (1, 8, 2, 160, 160, 32, True, 64)      # through the op: b, hq, hkv, s, s, d, ...
GQA_SEEDS = range(5)
# ragged Sq and Sk: Sq < Sk causal, Sq > Sk bidirectional
BWD_RAGGED_CASES = [(1, 4, 72, 300, 80, True, None), (1, 2, 100, 72, 80, False, None)]
# f32: the reference's gradient bound (tests/test_kernels.py); both sides run in
# f32.  bf16: 2e-2 + 2e-2 |want|.  Both sides round their outputs to bf16
# (spacing 2^-8 relative), so they may differ by one bf16 step; and B2's
# tensor-core variant rounds P and dS to bf16 before the dV and dK products,
# which the plain version takes in f32 (B1's rounds P before P.V, inside TOL).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU training parity, f32 through 2 full-width layers: loss rtol and
# the per-leaf relative error ||got - want|| / ||want|| of every gradient
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEPS = 4          # 1 warm-up + 3 timed
LOSS_RTOL = 2e-4         # bridge vs gspmd (tests/_distributed_worker.py)
MULTI_SIZES_MB = (1, 256)  # all-reduce payloads of the multi-card phase
MULTI_STEPS = 2            # training steps per grad-sync mode there

# B4 (RG-LRU): b, t, d, whether an initial state h0 is given.  The reference's
# test shapes (tests/test_kernels.py) and a nonzero h0 ...
LRU_CASES = [(2, 100, 48, False), (1, 256, 128, False), (3, 17, 8, False),
             (1, 1, 16, False), (2, 100, 48, True)]
# ... and recurrentgemma-9b serving 4 prompts of 512 (width 4096): prefill and
# a decode step (T = 1), both from the cache's state.  The model runs B4 on f32.
LRU_PREFILL = (4, 512, 4096, True)
LRU_DECODE = (4, 1, 4096, True)
# a ragged T over many stages of the ring (68 of 16 steps and 12), at the
# model's width; an odd D (one-element copies in the ring, one lane a thread
# in the step kernel)
LRU_RAGGED = (2, 1100, 4096, True)
LRU_ODD = [(2, 37, 33, True), (3, 1, 33, True)]
# B5 (WKV-6): b, h, t, dk, dv, whether an initial state s0 is given.  The
# reference's test shapes and a nonzero s0 ...
WKV_CASES = [(2, 3, 50, 16, 16, False), (1, 2, 64, 32, 32, False),
             (1, 1, 7, 8, 8, False), (2, 2, 33, 64, 64, False), (2, 3, 50, 16, 16, True)]
# ... and rwkv6-3b serving 4 prompts of 512 (40 heads of 64): prefill and a
# decode step, from the cache's state.  The model runs B5 on bf16 r/k/v/log_w.
WKV_PREFILL = (4, 40, 512, 64, 64, True)
WKV_DECODE = (4, 40, 1, 64, 64, True)
WKV_EXTREME = (1, 1, 64, 16, 16, False)   # log_w = -20 (test_wkv6_extreme_decay_stable)
# a ragged T over several chunks (64 + 64 + 64 + 8 steps), from s0
WKV_RAGGED = (1, 4, 200, 64, 64, True)
# the reference's bounds (tests/test_kernels.py): B4 y and h_last; B5 y (the
# state, f32 from the same inputs on both sides, at 5e-4 in both dtypes)
LRU_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
WKV_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
WKV_STATE_TOL = 5e-4
EXTREME_TOL = 1e-4
PATH_DTYPE = {"rg_lru_fwd": torch.float32, "wkv6_fwd": torch.bfloat16,
              "rg_lru_bwd": torch.float32, "wkv6_bwd": torch.bfloat16}
# the recurrent archs' training shapes (8 x 512): recurrentgemma-9b's RG-LRU
# (width 4096, f32) and rwkv6-3b's WKV-6 (40 heads of 64, bf16), for B4 and
# B5 and their backward B4' and B5'
LRU_TRAIN = (8, 512, 4096, False)
WKV_TRAIN = (8, 40, 512, 64, 64, False)
LRU_EXTREME = (2, 64, 48, True)   # a = e^-20: each step forgets almost all
# B4' and B5' against their plain versions: f32 as the CPU tests hold the
# plain backward to JAX's gradients (1e-5, 1e-4); bf16 2e-2 + 2e-2|want|
# (both sides round each gradient to bf16, and B4' reads h as the forward's
# bf16 y, one bf16 step from the plain version's f32 h)
LRU_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
WKV_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU training parity: arch, layers kept (recurrentgemma-9b's two
# RG-LRU layers; full width otherwise)
TRAIN_PARITY_ARCHS = (("stablelm-3b", 2), ("rwkv6-3b", 2), ("recurrentgemma-9b", 2))
# trained on the main path: arch, layers kept (None: all).  recurrentgemma-9b
# whole is ~9.4 G parameters, ~113 GB of bf16 weights and gradients and f32
# moments: one pattern period (rglru, rglru, local) at full width fits
TRAIN_ARCHS = (("stablelm-3b", None), ("rwkv6-3b", None), ("recurrentgemma-9b", 3))
# card vs CPU model parity: arch, layers kept (full width otherwise)
PARITY_ARCHS = (("stablelm-3b", 4), ("recurrentgemma-9b", 3), ("rwkv6-3b", 2),
                ("qwen3-moe-235b-a22b", 1), ("minicpm3-4b", 2), ("whisper-base", 6),
                ("internvl2-26b", 1))
# other cuts of the parity check: internvl2's 1024 patches to 64, so that the
# CPU side stays in seconds (whisper keeps its 6 encoder layers and 1500 frames)
PARITY_CUTS = {"internvl2-26b": {"frontend_seq": 64}}
SERVE_ARCHS = ("stablelm-3b", "recurrentgemma-9b", "rwkv6-3b", "qwen3-moe-235b-a22b",
               "minicpm3-4b", "whisper-base", "internvl2-26b")
# served prompt lengths (tokens; 512 unless named): whisper's decoder context
# is 448 tokens, so 64 + 32 new; internvl2 prepends its 1024 patches to 512
SERVE_PROMPT = {"whisper-base": 64}
# served depth where the whole model does not fit one card: qwen3-moe's 94
# layers are ~470 GB in bf16; 8 layers and the untied embed and unembed are
# ~42.3 GB.  The other served models keep their full configs.
SERVE_DEPTH = {"qwen3-moe-235b-a22b": 8}
# the SDPA backends tried for the attention yardstick (torch.nn.attention.SDPBackend)
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def phase(name: str):
    print(f"== {name}", flush=True)


def print_ptxas(log: str) -> None:
    """One line per compiled kernel: its (mangled) name, registers and spills,
    from ptxas's -v report."""
    name = stack = None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif "spill" in line:
            stack = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            print(f"  {name}: {m.group(1)} registers; {stack}")
            name = stack = None


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
    """q, k, v of a B1 case in f32 on the card (cast by the caller); v's head
    is the case's ninth field where it has one (MLA), else D."""
    b, hq, hkv, sq, sk, d = case[:6]
    dv = case[8] if len(case) > 8 else d
    gen = case_generator("fwd", case)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv))
    return [torch.randn(s, generator=gen, device="cuda") for s in shapes]


def flash_call(q, k, v, causal, window):
    """B1's wrapper at these inputs: (out, lse).  A value head narrower than
    the query head is zero-padded as `ops.flash_attention` pads it, and the
    output sliced back; the op's own output must equal it bit for bit."""
    d, dv = q.shape[-1], v.shape[-1]
    if dv == d:
        return flash_kernel.flash_attention_fwd_lse(q, k, v, scale=d ** -0.5,
                                                    causal=causal, window=window)
    out, lse = flash_kernel.flash_attention_fwd_lse(
        q, k, torch.nn.functional.pad(v, (0, d - dv)), scale=d ** -0.5, causal=causal,
        window=window)
    via_op = flash_ops.flash_attention(q, k, v, causal, window, d ** -0.5)
    if not torch.equal(via_op, out[..., :dv]):
        raise AssertionError("ops.flash_attention differs from the padded kernel call")
    return out[..., :dv], lse


def max_err(got, want, atol, rtol):
    """(max abs error, whether |got - want| <= atol + rtol |want| everywhere)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def bf16_row_err(got, want) -> tuple[float, bool]:
    """(the largest |got - want| beyond BF16_STEP |want|, over the rms of its
    row of want; whether it is within BF16_ROW_TOL): a bf16 output held to
    its own scale."""
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - BF16_STEP * want.abs()).clamp_min(0)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    ratio = (excess / rms).max().item()
    return ratio, ratio <= BF16_ROW_TOL


def check_flash(case, dtype) -> tuple[float, dict, str]:
    """B1 at `case` in `dtype` against its plain version: (the output's max
    abs error, each check's verdict, the printed line)."""
    d, causal, window = case[5], case[6], case[7]
    q, k, v = (t.to(dtype) for t in flash_inputs(case))
    fn = flash_kernel.flash_attention_fwd_lse
    tc_before = fn.launches_tc
    out, lse = flash_call(q, k, v, causal, window)
    torch.cuda.synchronize()
    want_out, want_lse = flash_ref.attention_fwd_lse(
        q, k, v, scale=d ** -0.5, causal=causal, window=window)
    err, ok = max_err(out, want_out, TOL[dtype], TOL[dtype])
    lse_err, lse_ok = max_err(lse, want_lse, LSE_TOL[dtype], LSE_TOL[dtype])
    verdicts = {"variant": fn.launches_tc - tc_before
                == (dtype == torch.bfloat16) * (1 + (len(case) > 8)),
                "out": ok, "lse": lse_ok,
                "shape": out.shape == want_out.shape and lse.shape == q.shape[:3]}
    line = (f"flash {case} {str(dtype)[6:]} inputs {input_hash(q, k, v)}: out "
            f"max|err| {err:.3e} (tol {TOL[dtype]}), lse max|err| {lse_err:.3e} "
            f"(tol {LSE_TOL[dtype]})")
    if dtype == torch.bfloat16:
        ratio, verdicts["out_row_scaled"] = bf16_row_err(out, want_out)
        line += f", out row-scaled err {ratio:.4f} (tol {BF16_ROW_TOL})"
    return err, verdicts, line


def flash_check_cases() -> list:
    """(case, dtype) of every check of B1 against its plain version."""
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16) for c in FLASH_CASES]
    cases += [(c, dt) for c in (SERVE_CASE, TRAIN_FWD_CASE, WIDE_CASE, GRIFFIN_CASE,
                                GRIFFIN_TRAIN_CASE, QWEN_CASE, *NEW_CASES, *RAGGED_CASES)
              for dt in (torch.bfloat16, torch.float32)]
    return cases


def check_kernels() -> dict:
    """Kernel vs plain version on the card; returns the bf16 errors at the
    serving and the training shape, keyed by the case."""
    errs = {}
    for case, dtype in flash_check_cases():
        err, verdicts, line = check_flash(case, dtype)
        print(line)
        if not verdicts["variant"]:
            raise AssertionError(f"flash {case} {dtype}: not the variant of its dtype")
        if not all(verdicts.values()):
            raise AssertionError(f"kernel disagrees with its plain version: {line}")
        if dtype == torch.bfloat16:  # the main paths' dtype
            errs[case] = err
    return errs


def time_ms(fn, iters=20, warmup=3, hold=False) -> float:
    """ms of one call of `fn`, from CUDA events around `iters` queued calls.
    Without `hold` (`ms`) the card waits for the host wherever a call's Python
    and launch work outlasts its kernel, so that host time counts.  With
    `hold` (`device_ms`) a sleep kernel holds the card while the calls are
    queued, so they run back to back and only device time counts."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(50_000_000)  # ~25 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(moved_bytes: int, flops: int,
          flop_s: float = H100_BF16_FLOP_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on the published H100 SXM peaks:
    bytes over the HBM rate, operations over `flop_s`, the peak of the
    inputs' type."""
    t_bytes = moved_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_backends(fn) -> list[str]:
    """The SDPA_BACKENDS under which `fn` (a call of SDPA, or one forward and
    backward) runs at its shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                fn()
            torch.cuda.synchronize()
            ok.append(name)
        except RuntimeError as exc:  # this backend has no kernel for the shape
            print(f"  SDPA backend {name} does not run here: {str(exc).splitlines()[0][:120]}")
    if not ok:
        raise AssertionError("no SDPA backend runs at this shape")
    return ok


def time_under(backend: str | None, fn, iters: int, hold: bool) -> float:
    """time_ms of `fn`, under the SDPA backend `backend` if one is given."""
    if backend is None:
        return time_ms(fn, iters=iters, hold=hold)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(getattr(SDPBackend, backend)):
        return time_ms(fn, iters=iters, hold=hold)


def time_in_turns(fns: dict, backends: dict, iters: dict) -> dict:
    """Median of three in turns of each fn's time; `backends` maps a key to
    the SDPA backend it runs under.  A key that ends in "device_ms" (or a
    tuple key whose last part does) is timed with the card held (device time
    only)."""
    runs = {key: [] for key in fns}
    for _ in range(3):
        for key, fn in fns.items():
            hold = (key[-1] if isinstance(key, tuple) else key).endswith("device_ms")
            runs[key].append(time_under(backends.get(key), fn, iters.get(key, 20), hold))
    return {key: sorted(v)[1] for key, v in runs.items()}


def sdpa_fns(fns: dict, backends: dict, names, fn) -> None:
    """Adds `fn` under each SDPA backend of `names` to `fns` (keys "sdpa NAME"
    and "sdpa NAME device_ms") and its backend to `backends`."""
    for name in names:
        for key in (f"sdpa {name}", f"sdpa {name} device_ms"):
            fns[key], backends[key] = fn, name


def pick_library(times: dict) -> None:
    """Moves the per-backend SDPA times of `times` into library_ms (the
    fastest backend's `ms`), library_backend, library_device_ms (the fastest
    backend's device time) and the per-backend dicts."""
    dev = {key[5:-10]: times.pop(key) for key in list(times)
           if key.startswith("sdpa ") and key.endswith(" device_ms")}
    by = {key[5:]: times.pop(key) for key in list(times) if key.startswith("sdpa ")}
    best = min(by, key=by.get)
    times["library_ms"], times["library_backend"] = by[best], best
    times["library_ms_by_backend"] = by
    times["library_device_ms"] = min(dev.values())
    times["library_device_ms_by_backend"] = dev


def library_text(times: dict) -> str:
    """The SDPA yardstick of `times`, both ways, with each backend's time."""
    def rounded(by):
        return {name: round(t, 4) for name, t in by.items()}
    return (f"library_ms {times['library_ms']:.4f} ({times['library_backend']}; by backend "
            f"{rounded(times['library_ms_by_backend'])}) library_device_ms "
            f"{times['library_device_ms']:.4f} (by backend "
            f"{rounded(times['library_device_ms_by_backend'])})")


def time_flash(case) -> dict:
    """B1 at `case`, bf16: kernel, plain, library (each SDPA backend), bound.
    A case with a narrower value head (MLA) times the op's call, padding and
    slice included, as the path makes it (`ms`, `device_ms`), and the kernel
    alone on V padded beforehand (`kernel_padded_device_ms`); its bound and
    library time are those of the unpadded function."""
    b, hq, hkv, sq, sk, d, causal, window = case[:8]
    q, k, v = (t.to(torch.bfloat16) for t in flash_inputs(case))
    dv = v.shape[-1]
    scale = d ** -0.5
    # SDPA has no sliding window: the yardstick only where the window
    # covers every causal key (recurrentgemma's 2048 at 512 tokens)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, scale=scale, enable_gqa=hq != hkv)
    if dv == d:
        call = lambda: flash_kernel.flash_attention_fwd_lse(  # noqa: E731
            q, k, v, scale=scale, causal=causal, window=window)
    else:
        call = lambda: flash_ops.flash_attention(q, k, v, causal, window, scale)  # noqa: E731
    fns = {"ms": call, "device_ms": call,
           "plain_ms": lambda: flash_ref.attention_fwd_lse(
               q, k, v, scale=scale, causal=causal, window=window)}
    if dv < d:
        v_pad = torch.nn.functional.pad(v, (0, d - dv))
        fns["kernel_padded_device_ms"] = lambda: flash_kernel.flash_attention_fwd_lse(
            q, k, v_pad, scale=scale, causal=causal, window=window)
    backends = {}
    sdpa_fns(fns, backends, sdpa_backends(sdpa), sdpa)
    times = time_in_turns(fns, backends, {})
    pick_library(times)
    # bound: each input read once and each output written once, against the
    # live (query, key) pairs of this mask at 2 D + 2 Dv FLOPs each (QK^T, PV)
    elem = q.element_size()
    moved = (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) * elem + b * hq * sq * 4
    live = int(flash_ref.attention_mask(sq, sk, causal, window).sum())
    flops = 2 * (d + dv) * live * b * hq
    times["bound_ms"], times["bound_by"] = bound(moved, flops)
    padded = (f" kernel_padded_device_ms {times['kernel_padded_device_ms']:.4f} (V padded "
              f"to {d} beforehand: {moved + b * hkv * sk * (d - dv) * elem + b * hq * sq * (d - dv) * elem} "
              f"bytes)" if dv < d else "")
    print(f"flash timing {case} bf16: kernel_ms {times['ms']:.4f} "
          f"device_ms {times['device_ms']:.4f}{padded} plain_ms {times['plain_ms']:.4f} "
          f"{library_text(times)} bound_ms {times['bound_ms']:.4f} "
          f"(by {times['bound_by']}: {moved} bytes, {flops} FLOP; H100 SXM peaks "
          f"{H100_HBM_BYTES_S:.3g} B/s, {H100_BF16_FLOP_S:.3g} FLOP/s)")
    return times


@contextlib.contextmanager
def recorded_routes(records: list):
    """While open, every MoE routing call appends (device type, top_i, keep,
    probs), on the host, to `records`."""
    route = moe_mod.route

    def recording(p, xg, m):
        out = route(p, xg, m)
        probs, _, top_i, _, keep = out
        records.append((xg.device.type, top_i.cpu(), keep.cpu(), probs.cpu()))
        return out

    moe_mod.route = recording
    try:
        yield records
    finally:
        moe_mod.route = route


def report_routing(arch: str, records: list, cfg) -> None:
    """Prints how many (token, choice) routing decisions (the expert, kept or
    dropped) agree between the card's and the CPU's calls, in call order,
    and the top-k probability gap (CPU) of every token whose decisions differ."""
    cpu = [r for r in records if r[0] == "cpu"]
    card = [r for r in records if r[0] == "cuda"]
    if len(cpu) != len(card) or not cpu:
        raise AssertionError(f"{arch}: {len(card)} routing calls on the card, "
                             f"{len(cpu)} on the CPU")
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    agree = total = 0
    gaps = []
    for (_, ti_c, keep_c, probs_c), (_, ti_g, keep_g, _) in zip(cpu, card, strict=True):
        # 0: not chosen, 1: chosen and dropped, 2: chosen and kept
        m_c, m_g = (torch.zeros(ti.shape[:-1] + (e,), dtype=torch.int8).scatter_(
            -1, ti, 1 + kp.to(torch.int8)) for ti, kp in ((ti_c, keep_c), (ti_g, keep_g)))
        agree += int(((m_c == m_g) & (m_c > 0)).sum())
        total += int((m_c > 0).sum())
        differ = (m_c != m_g).any(-1)
        top = probs_c.sort(dim=-1, descending=True).values
        gaps += (top[..., k - 1] - top[..., k])[differ].tolist()
    print(f"routing {arch} card vs cpu: {agree} of {total} (token, choice) decisions agree "
          f"over {len(cpu)} calls; {len(gaps)} tokens differ"
          + (f", top-k probability gaps (p_k - p_(k+1), CPU) {sorted(gaps)}" if gaps else ""))


@torch.inference_mode()
def check_model_parity(arch: str, num_layers: int) -> float:
    """Same f32 weights on the card and on the CPU: logits within MODEL_TOL.
    `arch` at its full width, cut to `num_layers` (and by PARITY_CUTS); a MoE
    arch's routing decisions are compared and printed too.  Whisper gets
    random frames and internvl2 random patches beside the tokens."""
    cfg = dataclasses.replace(configs.get(arch), num_layers=num_layers, dtype="float32",
                              **PARITY_CUTS.get(arch, {}))
    if arch == "stablelm-3b":
        cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
    else:  # drawn on the card: a 256k x 4096 f32 table is slow to draw on the host
        gpu_model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        cpu_model = copy.deepcopy(gpu_model).to("cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 131),
                           generator=torch.Generator().manual_seed(SEED + 1))
    extra = extra_inputs(cfg, 1, torch.Generator().manual_seed(SEED + 3))
    prompt, max_seq = tokens[:, :128], 136 + cfg.frontend_seq
    worst = 0.0
    with recorded_routes([]) as routes:
        logits_c, caches_c = prefill(cfg, cpu_model, {"tokens": prompt, **extra}, max_seq)
        logits_g, caches_g = prefill(cfg, gpu_model, {
            "tokens": prompt.cuda(), **{k: t.cuda() for k, t in extra.items()}}, max_seq)
        steps = [("prefill", logits_c, logits_g)]
        for t in range(128, 131):
            tok = tokens[:, t:t + 1]
            logits_c, caches_c = decode_step(cfg, cpu_model, tok, caches_c)
            logits_g, caches_g = decode_step(cfg, gpu_model, tok.cuda(), caches_g)
            steps.append((f"decode {t}", logits_c, logits_g))
    if cfg.ffn == "moe":
        report_routing(arch, routes, cfg)
    for name, want, got in steps:
        err, ok = max_err(got.cpu(), want, MODEL_TOL, MODEL_TOL)
        worst = max(worst, err)
        print(f"model parity {arch} ({num_layers} layers{cut_text(cfg, arch)}, f32) {name}: "
              f"max|err| {err:.3e} (tol {MODEL_TOL})")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"card and CPU logits of {arch} disagree at {name}")
    return worst


def extra_inputs(cfg, batch: int, gen: torch.Generator) -> dict:
    """The inputs beside the tokens, f32 on the host: whisper's frame
    embeddings (B, encoder_seq, d) and internvl2's patch embeddings
    (B, frontend_seq, d)."""
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen)
    if cfg.frontend == "patch_stub":
        extra["patches"] = torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen)
    return extra


def cut_text(cfg, arch: str) -> str:
    """The cuts of PARITY_CUTS and the encoder's depth, for the printed line."""
    parts = [f"{k} {v}" for k, v in PARITY_CUTS.get(arch, {}).items()]
    if cfg.enc_dec:
        parts.insert(0, f"+ {cfg.num_encoder_layers} encoder layers, {cfg.encoder_seq} frames")
    return "".join(f", {p}" for p in parts)


def expected_serve_launches(cfg, new_tokens: int) -> tuple[dict, dict]:
    """Kernel launches of one served run: (prefill, decode).  B1 once per
    attention or MLA layer in prefill (decode attends in plain PyTorch, as
    the reference does), and for whisper once per encoder layer and once per
    decoder layer's cross attention in prefill and in each of the
    new_tokens - 1 decode steps; B4 / B5 once per recurrent layer in prefill
    and in each decode step; no backward kernel."""
    kinds = cfg.layer_kinds
    cross = cfg.num_layers if cfg.enc_dec else 0
    per_pass = {"flash_attention_fwd": sum(k in ("attn", "local", "mla") for k in kinds)
                + cross + (cfg.num_encoder_layers if cfg.enc_dec else 0),
                "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
                "rg_lru_fwd": kinds.count("rglru"), "wkv6_fwd": kinds.count("rwkv6"),
                "rg_lru_bwd": 0, "wkv6_bwd": 0}
    per_step = dict(per_pass, flash_attention_fwd=cross)
    decode = {k: v * (new_tokens - 1) for k, v in per_step.items()}
    return per_pass, decode


@torch.inference_mode()
def serve_entry_points(cfg, model, prompts, extra: dict, new_tokens: int, max_seq: int,
                       progress) -> dict[int, list[int]]:
    """`serve_requests`' loop through the model entry points `prefill` and
    `decode_step`, for a model that needs inputs beside the tokens (whisper's
    frames, internvl2's patches), which the reference's serving driver does
    not take: prefill timed to the first greedy tokens on the host, then
    greedy decode of every request to `new_tokens`, with the driver's two
    progress lines."""
    batch = prompts.shape[0]
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, model, {"tokens": prompts.cuda(), **extra}, max_seq)
    tok = torch.argmax(logits, dim=-1)[:, None]
    host = [tok.cpu()]  # waits for the device
    dt = time.perf_counter() - t0
    progress(f"prefill: {batch} x {prompts.shape[1]} tokens in {dt:.3f}s "
             f"({prompts.numel() / dt:.1f} tok/s)")
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, caches = decode_step(cfg, model, tok, caches)
        tok = torch.argmax(logits, dim=-1)[:, None]
        host.append(tok.cpu())
    dt = time.perf_counter() - t0
    decoded = batch * (new_tokens - 1)
    progress(f"decode: {decoded} tokens in {new_tokens - 1} steps, {dt:.3f}s "
             f"({decoded / dt:.1f} tok/s)")
    out = torch.cat(host, dim=1)
    return {i: out[i].tolist() for i in range(batch)}


def serve_path(arch: str) -> dict:
    """`arch` at its full published config (its depth cut to SERVE_DEPTH
    where that names it) answers 4 requests of 512-token prompts (whisper:
    64, after encoding 1500 frames; internvl2: after its 1024 patches) and 32
    new tokens each, through `serve_requests`, or through the model entry
    points where the model needs frames or patches.  Returns the launch
    counts of the run, split into prefill and decode."""
    cfg = configs.get(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
    batch, prompt_len, new_tokens = 4, SERVE_PROMPT.get(arch, 512), 32
    max_seq = cfg.frontend_seq + prompt_len + new_tokens + 1
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    rng = torch.Generator().manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=rng,
                            dtype=torch.int32)
    extra = {k: t.cuda().to(torch.bfloat16) for k, t in
             extra_inputs(cfg, batch, torch.Generator().manual_seed(SEED + 3)).items()}
    reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=new_tokens)
            for i in range(batch)]
    messages, at_prefill, designs_at_prefill = [], {}, {}

    def progress(msg):
        if not messages:  # prefill is done (and synchronised): its launches so far
            at_prefill.update(read_launches())
            designs_at_prefill.update(read_designs())
        messages.append(msg)
        print(msg, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if extra:
        out = serve_entry_points(cfg, model, prompts, extra, new_tokens, max_seq, progress)
    else:
        out = serve_requests(cfg, model, reqs, max_seq=max_seq, progress=progress,
                             device="cuda")
    total = read_launches()
    designs_total = read_designs()
    check_tensor_core_launches(f"serve {arch}")
    peak = torch.cuda.max_memory_allocated()
    launches = {"prefill": at_prefill,
                "decode": {k: total[k] - at_prefill[k] for k in total}}
    want_prefill, want_decode = expected_serve_launches(cfg, new_tokens)
    if launches["prefill"] != want_prefill or launches["decode"] != want_decode:
        raise AssertionError(f"{arch}: launches in the served run {launches}, expected "
                             f"prefill {want_prefill}, decode {want_decode}")
    # every prefill call of B4 in the ring, of B5 (bf16) in the two-pass
    # design; every decode call (T = 1) of both in the step kernel
    designs = {"prefill": designs_at_prefill,
               "decode": {name: {k: designs_total[name][k] - designs_at_prefill[name][k]
                                 for k in keys} for name, keys in DESIGN_COUNTERS.items()}}
    want_designs = {
        "prefill": {"rg_lru_fwd": {"launches_step": 0},
                    "wkv6_fwd": {"launches_chunked": want_prefill["wkv6_fwd"],
                                 "launches_step": 0},
                    "wkv6_bwd": {"launches_chunked": 0, "launches_entry": 0}},
        "decode": {"rg_lru_fwd": {"launches_step": want_decode["rg_lru_fwd"]},
                   "wkv6_fwd": {"launches_chunked": 0,
                                "launches_step": want_decode["wkv6_fwd"]},
                   "wkv6_bwd": {"launches_chunked": 0, "launches_entry": 0}}}
    print(f"serve {arch}: B4 / B5 designs {designs}")
    if designs != want_designs:
        raise AssertionError(f"{arch}: B4 / B5 designs in the served run {designs}, "
                             f"expected {want_designs}")
    if any(len(out[i]) != new_tokens for i in range(batch)):
        raise AssertionError(f"token budgets not met: {[len(t) for t in out.values()]}")
    gen = torch.tensor([out[i] for i in range(batch)], dtype=torch.int32)
    if gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError("generated token id out of the vocabulary")

    # greedy agreement with a teacher-forced full forward (printed, not
    # asserted: bf16 near-ties can flip a greedy choice, and a MoE model's
    # capacity drops depend on how the tokens are grouped)
    full = torch.cat([prompts, gen], dim=1).cuda()
    with torch.inference_mode():
        logits = forward(cfg, model, {"tokens": full, **extra}, mode="train").logits
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits in the full forward")
    first = cfg.frontend_seq + prompt_len - 1  # the patches come before the prompt
    ref_tok = logits[:, first:-1].argmax(dim=-1).cpu()
    del logits
    agree = (ref_tok == gen).float().mean().item() * 100

    # one more decode step (from a fresh prefill) under the profiler: the
    # device's busy time and idle share in decode
    with torch.inference_mode():
        _, caches = prefill(cfg, model, {"tokens": prompts.cuda(), **extra}, max_seq)
        step = gen[:, :1].cuda()
        decode_step(cfg, model, step, caches)
        print(f"serve {arch} decode step (batch {batch}) under the profiler: "
              f"{profile_text(profiled(lambda: decode_step(cfg, model, step, caches)))}")
    if cfg.ffn == "moe":
        moe_breakdown(cfg, model)

    prefill_s = float(re.search(r"prefill: .* in ([0-9.]+)s", messages[0]).group(1))
    decode_tps = float(re.search(r"\(([0-9.]+) tok/s\)", messages[1]).group(1))
    inputs = ", ".join(f"{k} {tuple(t.shape)}" for k, t in extra.items())
    print(f"serve {arch} full config ({cfg.num_layers} layers"
          + (f" + {cfg.num_encoder_layers} encoder layers" if cfg.enc_dec else "") + "), "
          f"{batch} x ({prompt_len} + {new_tokens})" + (f" beside {inputs}" if extra else "")
          + f": prefill {prefill_s:.3f} s = {batch * prompt_len / prefill_s:.1f} tok/s"
          + (f" ({batch * (cfg.frontend_seq + prompt_len) / prefill_s:.1f} positions/s)"
             if cfg.frontend_seq else "") + ", "
          f"decode {decode_tps:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes), greedy agreement with full forward {agree:.1f}%, "
          f"launches prefill {launches['prefill']}, decode {launches['decode']}")
    return launches


def profiled(fn, top: int = 8) -> dict:
    """One call of `fn` (warm) under torch.profiler, CPU and CUDA: its wall
    ms (host clock, ending in a synchronize, the profiler's own cost
    included), the device ms (the kernels' device times summed: one stream),
    the device's idle share of the wall time, the host's reads of device
    values (`aten::_local_scalar_dense`, each a sync) and the `top` ops by
    their kernels' device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.key, round(e.self_device_time_total / 1e3, 4), e.count) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda op: -op[1])
    reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1 - device / wall if device else None,
            "host_reads": reads, "top_ops": ops[:top]}


def profile_text(prof: dict) -> str:
    if not prof["device_ms"]:
        return (f"wall {prof['wall_ms']:.3f} ms, device time not measured (the profiler "
                f"saw no kernel)")
    return (f"wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, idle "
            f"{prof['idle_share'] * 100:.1f} %, host reads of device values "
            f"{prof['host_reads']}, top ops (name, device ms, calls) {prof['top_ops']}")


@torch.inference_mode()
def moe_breakdown(cfg, model) -> None:
    """Layer 0's MoE FFN of a served model at the served prefill (4 x 512
    tokens: groups of `group_size`, one after another) and decode (one group
    of 4 tokens) shapes, bf16, timed with CUDA events (`time_ms`): the whole
    FFN, its three expert products per group (`layers.dot`: f32
    accumulation and output), the same three as plain bf16 `torch.bmm`, and
    its dispatch and combine products; beside the least time of the FFN's
    bytes (the expert weights once) and FLOPs."""
    from repro_torch.models import layers

    p, m, d = model.blocks[0]["ffn"], cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    gen = case_generator("moe", cfg.name)
    bf16 = torch.bfloat16
    weight_bytes = sum(p[k].numel() * p[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    for name, tokens in (("prefill", 4 * 512), ("decode", 4)):
        gs = min(m.group_size, tokens)
        n, c = tokens // gs, moe_mod._capacity(gs, m)
        x = torch.randn((1, tokens, d), generator=gen, device="cuda").to(bf16)
        xe = torch.randn((e, c, d), generator=gen, device="cuda").to(bf16)
        hu = torch.randn((e, c, f), generator=gen, device="cuda").to(bf16)
        xg = torch.randn((1, gs, d), generator=gen, device="cuda").to(bf16)
        ye = torch.randn((1, e * c, d), generator=gen, device="cuda").to(bf16)
        disp = torch.zeros((1, gs, e * c), dtype=bf16, device="cuda")

        def groups(fn):
            return lambda: [fn() for _ in range(n)]

        fns = {
            "ffn": lambda: moe_mod.moe_ffn(cfg, p, x),
            "experts": groups(lambda: (layers.dot(xe, p["w_gate"]), layers.dot(xe, p["w_up"]),
                                       layers.dot(hu, p["w_down"]))),
            "experts_bf16_bmm": groups(lambda: (torch.bmm(xe, p["w_gate"]),
                                                torch.bmm(xe, p["w_up"]),
                                                torch.bmm(hu, p["w_down"]))),
            "dispatch_combine": groups(lambda: (torch.matmul(disp.mT, xg),
                                                torch.matmul(disp, ye))),
        }
        ms = {key: time_ms(fn, iters=10) for key, fn in fns.items()}
        print(f"moe {cfg.name} layer 0 {name} FFN under the profiler: "
              f"{profile_text(profiled(fns['ffn']))}")
        flops = n * (3 * 2 * e * c * d * f + 2 * 2 * gs * e * c * d)
        moved = weight_bytes + 2 * x.numel() * x.element_size()
        bound_ms, by = bound(moved, flops)
        print(f"moe {cfg.name} layer 0 {name} ({n} group(s) of {gs} tokens, C = {c}), bf16, "
              f"ms: {ms}; bound_ms {bound_ms:.4f} (by {by}: {moved} bytes, {flops} FLOP, of "
              f"which dispatch and combine {n * 4 * gs * e * c * d})")


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


def attention_f64(q, k, v, causal: bool, window: int | None):
    """Masked softmax attention on f64 CPU tensors, GQA expanded: the truth
    that both f32 sides of the GQA gradient check are printed against."""
    group = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    mask = flash_ref.attention_mask(q.shape[2], k.shape[2], causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", s.masked_fill(~mask, float("-inf")).softmax(-1), v)


def check_bwd_kernels() -> dict:
    """B2 and B3 vs their plain versions on the card; returns their errors at
    the training shapes in bf16 (the main paths' dtype), keyed by (kernel,
    case)."""
    errs = {}
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16)
             for c in BWD_CASES + [TRAIN_CASE, GRIFFIN_BWD_CASE, WIDE_BWD_CASE,
                                   *BWD_RAGGED_CASES]]
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
        if case in (TRAIN_CASE, GRIFFIN_BWD_CASE) and dtype == torch.bfloat16:
            errs[("flash_attention_bwd_dkv", case)] = max(results["dk"][0], results["dv"][0])
            errs[("flash_attention_bwd_dq", case)] = results["dq"][0]
    # GQA through the op (K/V expanded, dK/dV group-summed): card vs CPU, f32,
    # on several seeds; both sides are also printed against an f64 truth, so
    # that a jump of the card-vs-CPU error shows which side moved
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
        tq, tk, tv = (t.to("cpu", torch.float64).requires_grad_() for t in (q, k, v))
        out = attention_f64(tq, tk, tv, causal, window)
        truth = torch.autograd.grad((out * g.to("cpu", torch.float64)).sum(), (tq, tk, tv))
        results, vs_f64 = {}, []
        for name, got, again, want, exact in zip(("dq", "dk", "dv"), *grads, truth,
                                                 strict=True):
            results[name] = max_err(got.cpu(), want, tol, tol)
            vs_f64.append(f"{name} card {(got.cpu().double() - exact).abs().max().item():.3e} "
                          f"cpu {(want.double() - exact).abs().max().item():.3e}")
            # no atomics and a fixed order of every sum: a second run is bit-identical
            if not torch.equal(got, again):
                raise AssertionError(f"GQA gradient {name} differs between two runs "
                                     f"on the card (seed {seed})")
        line = (f"flash op grad GQA {GQA_CASE} f32 card vs cpu, seed {seed} inputs "
                f"{input_hash(q, k, v, g)}: "
                + ", ".join(f"{n} max|err| {e:.3e}" for n, (e, _) in results.items())
                + f" (tol {tol} + {tol}|want|); against f64: " + ", ".join(vs_f64))
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


def time_bwd(case) -> dict:
    """B2 and B3 at a training shape, bf16: kernel, plain, library, bound.
    SDPA has no sliding window: its causal backward is the yardstick where
    the window covers every causal key (recurrentgemma-9b's 2048 at 512)."""
    b, h, sq, sk, d, causal, window = case
    if window is not None and window < sk:
        raise ValueError(f"{case}: a window shorter than the keys has no SDPA yardstick")
    q, k, v, do, o, lse, dvec = bwd_inputs(case, torch.bfloat16)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    # the library yardstick: the backward of PyTorch's fused attention on the
    # same inputs (dq, dk and dv together) under each SDPA backend that runs
    # here, timed only for comparison
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

    def library_fn(backend):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(getattr(SDPBackend, backend)):
            lout = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, scale=d ** -0.5)
        return lambda: torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True)

    library = {name: library_fn(name) for name in sdpa_backends(
        lambda: torch.autograd.grad(torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, scale=d ** -0.5), (lq, lk, lv), do))}
    fns = {
        "flash_attention_bwd_dkv": {
            "ms": lambda: flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw),
            "device_ms": lambda: flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw),
            "plain_ms": lambda: flash_ref.attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)},
        "flash_attention_bwd_dq": {
            "ms": lambda: flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw),
            "device_ms": lambda: flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw),
            "plain_ms": lambda: flash_ref.attention_bwd_dq(q, k, v, do, lse, dvec, **kw)},
    }
    flat = {(name, key): fn for name, f in fns.items() for key, fn in f.items()}
    backends = {}
    for name, fn in library.items():
        sdpa_fns(flat, backends, [name], fn)
    med = time_in_turns(flat, backends, {key: 10 for key in flat})
    lib = {key: med.pop(key) for key in list(med) if isinstance(key, str)}
    pick_library(lib)
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
        times[name] = {"ms": med[(name, "ms")], "device_ms": med[(name, "device_ms")],
                       "plain_ms": med[(name, "plain_ms")],
                       "bound_ms": bound_ms, "bound_by": by, **lib}
        t = times[name]
        print(f"{name} timing {case} bf16: kernel_ms {t['ms']:.4f} device_ms "
              f"{t['device_ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} SDPA backward (dq dk dv): {library_text(t)} "
              f"bound_ms {bound_ms:.4f} (by {by}: {moved} bytes, {flops} FLOP)")
    return times


def lru_inputs(case, dtype):
    """a, b (in `dtype`) and h0 (f32 or None) of a B4 case on the card."""
    b, t, d, with_h0 = case
    gen = case_generator("lru", case)
    a = (torch.rand((b, t, d), generator=gen, device="cuda") * 0.79 + 0.2).to(dtype)
    x = torch.randn((b, t, d), generator=gen, device="cuda").to(dtype)
    h0 = torch.randn((b, d), generator=gen, device="cuda") if with_h0 else None
    return a, x, h0


def wkv_inputs(case, dtype):
    """r, k, v, log_w (in `dtype`), u and s0 (f32 or None) of a B5 case on the card."""
    b, h, t, dk, dv, with_s0 = case
    gen = case_generator("wkv", case)
    r, k = (torch.randn((b, h, t, dk), generator=gen, device="cuda") for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=gen, device="cuda")
    log_w = -torch.exp(torch.randn((b, h, t, dk), generator=gen, device="cuda"))
    u = torch.randn((h, dk), generator=gen, device="cuda")
    s0 = torch.randn((b, h, dk, dv), generator=gen, device="cuda") if with_s0 else None
    return (*(x.to(dtype) for x in (r, k, v, log_w)), u, s0)


def check_recurrent_kernels() -> dict:
    """B4 and B5 vs their plain versions on the card, in f32 and bf16; returns
    the errors at the serving and training shapes in the dtype the model runs
    them in."""
    errs = {}
    dtypes = (torch.float32, torch.bfloat16)
    lru_cases = LRU_CASES + [LRU_DECODE, LRU_PREFILL, LRU_TRAIN, LRU_RAGGED] + LRU_ODD
    for case, dtype in [(c, dt) for c in lru_cases for dt in dtypes]:
        a, x, h0 = lru_inputs(case, dtype)
        y, h = lru_call(a, x, h0)
        torch.cuda.synchronize()
        want_y, want_h = lru_ref.rg_lru_scan(a, x, h0)
        tol = LRU_TOL[dtype]
        (ey, ok_y), (eh, ok_h) = max_err(y, want_y, tol, tol), max_err(h, want_h, tol, tol)
        # one multiply and one add a step, each rounded, in order: the bits of
        # the plain version
        same = torch.equal(y, want_y) and torch.equal(h, want_h)
        line = (f"rg_lru {case} {str(dtype)[6:]} inputs {input_hash(a, x, *([h0] if case[3] else []))}: "
                f"y max|err| {ey:.3e}, h_last max|err| {eh:.3e} (tol {tol} + {tol}|want|), "
                f"bit-identical {same}")
        print(line)
        if not (ok_y and ok_h) or y.shape != a.shape or y.dtype != a.dtype \
                or not torch.isfinite(y).all():
            raise AssertionError(f"B4 disagrees with its plain version: {line}")
        if dtype == torch.float32 and not same:
            raise AssertionError(f"B4 in f32 differs from its plain version's bits: {line}")
        if case in (LRU_PREFILL, LRU_DECODE, LRU_TRAIN) and dtype == PATH_DTYPE["rg_lru_fwd"]:
            errs[("rg_lru_fwd", case)] = max(ey, eh)
    for dtype in dtypes:
        args = lru_inputs(LRU_RAGGED, dtype)
        first, second = (lru_call(*args) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second, strict=True)):
            raise AssertionError(f"B4's ring differs between two runs on the card ({dtype})")
    print("rg_lru ring: two runs on the card are bit-identical (f32, bf16)")
    for case, dtype in [(c, dt) for c in WKV_CASES + [WKV_DECODE, WKV_PREFILL, WKV_RAGGED]
                        for dt in dtypes] + [(WKV_TRAIN, PATH_DTYPE["wkv6_fwd"])]:
        r, k, v, log_w, u, s0 = wkv_inputs(case, dtype)
        y, s = wkv_call(r, k, v, log_w, u, s0)
        torch.cuda.synchronize()
        want_y, want_s = wkv_ref.wkv6_scan(r, k, v, torch.exp(log_w.float()), u, s0)
        tol = WKV_TOL[dtype]
        (ey, ok_y) = max_err(y, want_y, tol, tol)
        (es, ok_s) = max_err(s, want_s, WKV_STATE_TOL, WKV_STATE_TOL)
        line = (f"wkv6 {case} {str(dtype)[6:]} inputs "
                f"{input_hash(r, k, v, log_w, u, *([s0] if case[5] else []))}: y max|err| "
                f"{ey:.3e} (tol {tol} + {tol}|want|), state max|err| {es:.3e} (tol "
                f"{WKV_STATE_TOL} + {WKV_STATE_TOL}|want|)")
        print(line)
        if not (ok_y and ok_s) or y.shape != v.shape or y.dtype != r.dtype \
                or not torch.isfinite(y).all():
            raise AssertionError(f"B5 disagrees with its plain version: {line}")
        if case in (WKV_PREFILL, WKV_DECODE, WKV_TRAIN) and dtype == PATH_DTYPE["wkv6_fwd"]:
            errs[("wkv6_fwd", case)] = max(ey, es)
    # extreme decay: every step forgets almost all (log_w = -20); f32 runs the
    # first design, bf16 the two-pass one
    for dtype, tol in ((torch.float32, EXTREME_TOL), (torch.bfloat16, WKV_TOL[torch.bfloat16])):
        r, k, v, _, _, _ = wkv_inputs(WKV_EXTREME, dtype)
        log_w = torch.full_like(r, -20.0)
        u = torch.ones((r.shape[1], r.shape[3]), device="cuda")
        y, _ = wkv_call(r, k, v, log_w, u)
        torch.cuda.synchronize()
        want_y, _ = wkv_ref.wkv6_scan(r, k, v, torch.exp(log_w.float()), u)
        err, ok = max_err(y, want_y, tol, tol)
        line = (f"wkv6 {WKV_EXTREME} {str(dtype)[6:]} log_w = -20 inputs {input_hash(r, k, v)}: "
                f"y max|err| {err:.3e} (tol {tol} + {tol}|want|), finite "
                f"{bool(torch.isfinite(y).all())}")
        print(line)
        if not ok or not torch.isfinite(y).all():
            raise AssertionError(f"B5 at extreme decay: {line}")
    # the two-pass design sums in a fixed order: a second run gives the same bits
    args = wkv_inputs(WKV_PREFILL, torch.bfloat16)
    first, second = (wkv_kernel.wkv6_fwd(*args)[:2] for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second, strict=True)):
        raise AssertionError("B5's two-pass design differs between two runs on the card")
    print("wkv6 two-pass design: two runs on the card are bit-identical")
    return errs


def lru_call(a, x, h0=None):
    """B4 through its wrapper, checking by the counters that the design of
    this T ran: the step kernel at T = 1, the ring above."""
    fn = lru_kernel.rg_lru_fwd
    before = (fn.launches, fn.launches_step)
    out = fn(a, x, h0)
    want = (before[0] + 1, before[1] + (a.shape[1] == 1))
    if (fn.launches, fn.launches_step) != want:
        raise AssertionError(f"B4 at {tuple(a.shape)} {a.dtype}: (launches, step) "
                             f"{(fn.launches, fn.launches_step)}, expected {want}")
    return out


def wkv_call(r, k, v, log_w, u, s0=None):
    """B5 through its wrapper, checking by the counters that the design of
    this dtype and T ran: the step kernel at T = 1, the two-pass design for
    bf16 above, the first design for f32 above."""
    fn = wkv_kernel.wkv6_fwd
    before = (fn.launches, fn.launches_chunked, fn.launches_step)
    out = fn(r, k, v, log_w, u, s0)
    step, chunked = r.shape[2] == 1, r.shape[2] > 1 and r.dtype == torch.bfloat16
    want = (before[0] + 1, before[1] + chunked, before[2] + step)
    if (fn.launches, fn.launches_chunked, fn.launches_step) != want:
        raise AssertionError(f"B5 at {tuple(r.shape)} {r.dtype}: (launches, chunked, step) "
                             f"{(fn.launches, fn.launches_chunked, fn.launches_step)}, "
                             f"expected {want}")
    return out[:2]


def wkv_work(r, v, s0) -> tuple[int, int, int]:
    """(bytes, FLOPs, exps) B5 needs for these inputs: r, k, v, log_w, u and
    s0 read once, y and the state written once; the chunked form's operations
    (a multiply-add counts 2) and its exponentials, chunk by chunk."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    elem = r.element_size()
    moved = (3 * r.numel() + v.numel()) * elem + h * dk * 4 + v.numel() * elem \
        + (2 if s0 is not None else 1) * b * h * dk * dv * 4
    flops = exps = 0
    for t0 in range(0, t, 64):
        n = min(64, t - t0)
        pairs = n * (n - 1) // 2
        flops += (n * dk                          # cumulative sum of log_w
                  + 3 * (pairs + n) * dk          # A: r k e, and the bonus diagonal
                  + 2 * (pairs + n) * dv          # A @ V
                  + 2 * n * dk                    # r e^{c}, k e^{c_last - c}
                  + 2 * n * dk * dv               # (r e^{c}) @ S
                  + dk * dv * (1 + 2 * n))        # S update
        exps += pairs * dk + 2 * n * dk + dk
    return moved, flops * b * h, exps * b * h


def time_recurrent() -> dict:
    """B4 and B5 at the serving prefill and decode shapes and at the training
    shapes, in the dtype the model runs them in: kernel and plain version
    (CUDA events), beside the bound.  No single PyTorch call computes either recurrence over T, so
    prefill has no library time; B4's decode step is one torch.addcmul
    (h_1 = b_1 + a_1 h0, its one (B, D) output standing for y and h_last),
    checked against the plain version at LRU_TOL and timed both ways."""
    times = {}
    for name, case in (("rg_lru_fwd", LRU_PREFILL), ("rg_lru_fwd", LRU_DECODE),
                       ("rg_lru_fwd", LRU_TRAIN), ("wkv6_fwd", WKV_PREFILL),
                       ("wkv6_fwd", WKV_DECODE), ("wkv6_fwd", WKV_TRAIN)):
        dtype = PATH_DTYPE[name]
        library = None
        if name == "rg_lru_fwd":
            a, x, h0 = lru_inputs(case, dtype)
            fns = {"ms": lambda: lru_kernel.rg_lru_fwd(a, x, h0),
                   "plain_ms": lambda: lru_ref.rg_lru_scan(a, x, h0)}
            moved = (3 * a.numel()) * a.element_size() + (1 + (h0 is not None)) \
                * a.shape[0] * a.shape[2] * 4
            flops, extra = 2 * a.numel(), ""
            if case[1] == 1:
                library = lambda: torch.addcmul(x[:, 0], a[:, 0], h0)  # noqa: E731
                got, (want, _) = library(), lru_ref.rg_lru_scan(a, x, h0)
                err, ok = max_err(got, want[:, 0], LRU_TOL[dtype], LRU_TOL[dtype])
                print(f"rg_lru library torch.addcmul(b, a, h0) {case}: max|err| {err:.3e} "
                      f"against the plain version (tol {LRU_TOL[dtype]} + "
                      f"{LRU_TOL[dtype]}|want|)")
                if not ok:
                    raise AssertionError("torch.addcmul disagrees with B4's plain version")
                fns["library_ms"] = fns["library_device_ms"] = library
        else:
            r, k, v, log_w, u, s0 = wkv_inputs(case, dtype)
            fns = {"ms": lambda: wkv_kernel.wkv6_fwd(r, k, v, log_w, u, s0),
                   "plain_ms": lambda: wkv_ref.wkv6_scan(r, k, v, torch.exp(log_w.float()),
                                                         u, s0)}
            moved, flops, exps = wkv_work(r, v, s0)
            extra = f", {exps} exps"
        fns["device_ms"] = fns["ms"]
        t = time_in_turns(fns, {}, {"plain_ms": 10})
        t["bound_ms"], t["bound_by"] = bound(moved, flops, PEAK_FLOP_S[dtype])
        if library is None:
            t["library_ms"] = t["library_device_ms"] = None
            lib_text = "library_ms none (no PyTorch call computes the recurrence)"
        else:
            lib_text = (f"library_ms {t['library_ms']:.4f} library_device_ms "
                        f"{t['library_device_ms']:.4f} (torch.addcmul)")
        times[(name, case)] = t
        print(f"{name} timing {case} {str(dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
              f"{t['device_ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} {lib_text} bound_ms {t['bound_ms']:.4f} "
              f"(by {t['bound_by']}: {moved} bytes, "
              f"{flops} FLOP{extra}; peak {PEAK_FLOP_S[dtype]:.3g} FLOP/s for "
              f"{str(dtype)[6:]})")
    return times


def lru_bwd_inputs(case, dtype, decay=None):
    """a, b and the cotangent gy (in `dtype`), h0 and the cotangent gh_last
    (f32, or None without h0) of a B4' case; a = e^decay where given."""
    b, t, d, with_h0 = case
    gen = case_generator("lru_bwd", case, decay)
    a = torch.rand((b, t, d), generator=gen, device="cuda") * 0.79 + 0.2
    if decay is not None:
        a = torch.full_like(a, math.exp(decay))
    x, gy = (torch.randn((b, t, d), generator=gen, device="cuda") for _ in range(2))
    h0, gh = ((torch.randn((b, d), generator=gen, device="cuda") for _ in range(2))
              if with_h0 else (None, None))
    return a.to(dtype), x.to(dtype), h0, gy.to(dtype), gh


def wkv_bwd_inputs(case, dtype, log_w=None):
    """r, k, v, log_w and the cotangent gy (in `dtype`), u, s0 and the
    cotangent gs_last (f32, or None without s0) of a B5' case; log_w fixed
    where given."""
    b, h, t, dk, dv, with_s0 = case
    gen = case_generator("wkv_bwd", case, log_w)
    r, k = (torch.randn((b, h, t, dk), generator=gen, device="cuda") for _ in range(2))
    v, gy = (torch.randn((b, h, t, dv), generator=gen, device="cuda") for _ in range(2))
    lw = -torch.exp(torch.randn((b, h, t, dk), generator=gen, device="cuda"))
    if log_w is not None:
        lw = torch.full_like(lw, log_w)
    u = torch.randn((h, dk), generator=gen, device="cuda")
    s0, gs = ((torch.randn((b, h, dk, dv), generator=gen, device="cuda") for _ in range(2))
              if with_s0 else (None, None))
    return (*(x.to(dtype) for x in (r, k, v, lw)), u, s0, gy.to(dtype), gs)


def lru_bwd_call(a, x, h0, y, gy, gh):
    """B4' through its wrapper, counted."""
    fn = lru_kernel.rg_lru_bwd
    before = fn.launches
    out = fn(a, x, h0, y, gy, gh)
    if fn.launches != before + 1:
        raise AssertionError(f"B4' at {tuple(a.shape)}: launches {fn.launches}, expected "
                             f"{before + 1}")
    return out


def wkv_bwd_call(r, k, v, log_w, u, s0, gy, gs, ws):
    """B5' through its wrapper, checking by the counters that a bf16 call
    took the chunked design and that it walked the chunk-entry states itself
    exactly when the forward left none."""
    fn = wkv_kernel.wkv6_bwd
    before = (fn.launches, fn.launches_chunked, fn.launches_entry)
    out = fn(r, k, v, log_w, u, s0, gy, gs, ws)
    want = (before[0] + 1, before[1] + (r.dtype == torch.bfloat16), before[2] + (ws is None))
    got = (fn.launches, fn.launches_chunked, fn.launches_entry)
    if got != want:
        raise AssertionError(f"B5' at {tuple(r.shape)} {r.dtype}: (launches, chunked, entry) "
                             f"{got}, expected {want}")
    return out


def grads_text(names, results) -> str:
    return ", ".join(f"{n} max|err| {e:.3e}" for n, (e, _) in zip(names, results, strict=True))


def check_recurrent_bwd_kernels() -> dict:
    """B4' and B5' vs their plain versions on the card, in f32 and bf16, each
    run twice (the same bits); returns their errors at the training shapes."""
    errs = {}
    dtypes = (torch.float32, torch.bfloat16)
    lru_cases = [(c, dt, None) for c in LRU_CASES + [LRU_RAGGED] for dt in dtypes] \
        + [(LRU_TRAIN, PATH_DTYPE["rg_lru_bwd"], None)] \
        + [(LRU_EXTREME, dt, -20.0) for dt in dtypes]
    for case, dtype, decay in lru_cases:
        a, x, h0, gy, gh = lru_bwd_inputs(case, dtype, decay)
        y, _ = lru_kernel.rg_lru_fwd(a, x, h0)
        got, again = (lru_bwd_call(a, x, h0, y, gy, gh) for _ in range(2))
        torch.cuda.synchronize()
        want = lru_ref.rg_lru_scan_bwd(a, x, h0, gy, gh)
        tol = LRU_BWD_TOL[dtype]
        results = [max_err(g, w, tol, tol) for g, w in zip(got, want, strict=True)]
        runs = all(torch.equal(g, z) for g, z in zip(got, again, strict=True))
        plain = all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        line = (f"rg_lru_bwd {case} {str(dtype)[6:]}{'' if decay is None else ' a = e^-20'} "
                f"inputs {input_hash(a, x, gy, *([h0, gh] if case[3] else []))}: "
                f"{grads_text(('da', 'db', 'dh0'), results)} (tol {tol} + {tol}|want|), "
                f"bit-identical to the plain version {plain}, two runs bit-identical {runs}")
        print(line)
        if not all(ok for _, ok in results) or not runs \
                or not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"B4' disagrees with its plain version: {line}")
        # one add and two multiplies a step, each rounded, in the plain
        # version's order, from the forward's y, which in f32 is h itself
        if dtype == torch.float32 and not plain:
            raise AssertionError(f"B4' in f32 differs from its plain version's bits: {line}")
        if case == LRU_TRAIN:
            errs[("rg_lru_bwd", case)] = max(e for e, _ in results)
    wkv_cases = [(c, dt, None) for c in WKV_CASES + [WKV_RAGGED] for dt in dtypes] \
        + [(WKV_TRAIN, PATH_DTYPE["wkv6_bwd"], None)] \
        + [(WKV_EXTREME, dt, -20.0) for dt in dtypes]
    names = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
    for case, dtype, log_w in wkv_cases:
        r, k, v, lw, u, s0, gy, gs = wkv_bwd_inputs(case, dtype, log_w)
        # bf16 with T > 1: from the two-pass forward's chunk-entry states
        _, _, ws = wkv_kernel.wkv6_fwd(r, k, v, lw, u, s0)
        got, again = (wkv_bwd_call(r, k, v, lw, u, s0, gy, gs, ws) for _ in range(2))
        torch.cuda.synchronize()
        want = wkv_ref.wkv6_scan_bwd(r, k, v, lw, u, s0, gy, gs)
        tol = WKV_BWD_TOL[dtype]
        results = [max_err(g, w, tol, tol) for g, w in zip(got, want, strict=True)]
        runs = all(torch.equal(g, z) for g, z in zip(got, again, strict=True))
        line = (f"wkv6_bwd {case} {str(dtype)[6:]}{'' if log_w is None else ' log_w = -20'} "
                f"states {'forward' if ws is not None else 'own'} inputs "
                f"{input_hash(r, k, v, lw, u, gy, *([s0, gs] if case[5] else []))}: "
                f"{grads_text(names, results)} (tol {tol} + {tol}|want|), two runs "
                f"bit-identical {runs}")
        print(line)
        if not all(ok for _, ok in results) or not runs \
                or not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"B5' disagrees with its plain version: {line}")
        if case == WKV_TRAIN:
            errs[("wkv6_bwd", case)] = max(e for e, _ in results)
    return errs


def wkv_bwd_work(r, v, s0, ws) -> tuple[int, int]:
    """(bytes, FLOPs) B5' needs for these inputs: r, k, v, log_w, gy, u, the
    chunk-entry states (and s0, gs_last) read once, dr, dk, dv, dlog_w, du
    and ds0 written once; per state entry and step a multiply-add each for
    dr, dk, dv and dlog_w, three operations for G_{t-1} = w G + r gy and three
    to recompute S once (a multiply-add counts 2), and per step the bonus
    terms (v . gy and sum_i u r k; dr, dk, dlog_w and du per row)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    elem = r.element_size()
    state = b * h * dk * dv * 4
    moved = (3 * r.numel() + 2 * v.numel()) * elem + h * dk * 4 + ws.numel() * 4 \
        + (2 * state if s0 is not None else 0) \
        + (3 * r.numel() + v.numel()) * elem + h * dk * 4 + state
    flops = b * h * t * (14 * dk * dv + 2 * dv + 13 * dk)
    return moved, flops


def wkv_bwd_tc_flops(r) -> int:
    """The FLOP that B5''s chunked design (bf16) runs on TF32 mma.sync for
    r's shape, each m16n8k8 product 2,048 FLOP, T padded to 64-step chunks.
    A chunk takes 512 in the gradient-state pass (8 warps x 8 k-steps x 4
    tiles x 2 parts of r e^{c}) and, in the gradient pass, 456 - 16 w for
    warp w: dA 8 (2 w + 2), the products with S_in and G_out 3 x 64, A's
    quarter 8, A's block 16, the intra-chunk ones with their decayed operand
    in two parts 2 x (8 x 6 + 2 x 8), and A past the block and its product
    with gy 16 (6 - 2 w)."""
    b, h, t, _ = r.shape
    per_chunk = 512 + sum(456 - 16 * w for w in range(4))
    return b * h * -(-t // 64) * per_chunk * 2048


def time_recurrent_bwd() -> dict:
    """B4' and B5' at the training shapes, in the dtype the model runs them
    in: kernel (`ms`, `device_ms`) and plain version (fewer calls), beside the
    bound.  No single PyTorch call computes either; B4' is shown beside a
    torch.add that moves its bytes (`yardstick_ms`, `yardstick_device_ms`)."""
    times = {}
    a, x, h0, gy, gh = lru_bwd_inputs(LRU_TRAIN, PATH_DTYPE["rg_lru_bwd"])
    y, _ = lru_kernel.rg_lru_fwd(a, x, h0)
    n = a.numel()
    moved = 5 * n * a.element_size()               # a, y, gy read; da, db written
    m = -(-moved // (3 * 4))                       # torch.add: two f32 reads, one write
    p, q, o = (torch.randn(m, device="cuda") for _ in range(3))
    fns = {"ms": lambda: lru_kernel.rg_lru_bwd(a, x, h0, y, gy, gh),
           "plain_ms": lambda: lru_ref.rg_lru_scan_bwd(a, x, h0, gy, gh),
           "yardstick_ms": lambda: torch.add(p, q, out=o)}
    fns["device_ms"], fns["yardstick_device_ms"] = fns["ms"], fns["yardstick_ms"]
    t = time_in_turns(fns, {}, {"plain_ms": 3})
    t["bound_ms"], t["bound_by"] = bound(moved, 3 * n, PEAK_FLOP_S[a.dtype])
    t["library_ms"] = t["library_device_ms"] = None
    times[("rg_lru_bwd", LRU_TRAIN)] = t
    print(f"rg_lru_bwd timing {LRU_TRAIN} {str(a.dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
          f"{t['device_ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms none (no PyTorch "
          f"call computes the gradient); torch.add moving its {3 * m * 4} bytes "
          f"yardstick_ms {t['yardstick_ms']:.4f} yardstick_device_ms "
          f"{t['yardstick_device_ms']:.4f}; bound_ms {t['bound_ms']:.4f} (by {t['bound_by']}: "
          f"{moved} bytes, {3 * n} FLOP)")
    r, k, v, lw, u, s0, gy, gs = wkv_bwd_inputs(WKV_TRAIN, PATH_DTYPE["wkv6_bwd"])
    _, _, ws = wkv_kernel.wkv6_fwd(r, k, v, lw, u, s0)
    fns = {"ms": lambda: wkv_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy, gs, ws),
           "plain_ms": lambda: wkv_ref.wkv6_scan_bwd(r, k, v, lw, u, s0, gy, gs)}
    fns["device_ms"] = fns["ms"]
    t = time_in_turns(fns, {}, {"plain_ms": 1})
    moved, flops = wkv_bwd_work(r, v, s0, ws)
    t["bound_ms"], t["bound_by"] = bound(moved, flops, PEAK_FLOP_S[r.dtype])
    t["library_ms"] = t["library_device_ms"] = None
    times[("wkv6_bwd", WKV_TRAIN)] = t
    print(f"wkv6_bwd timing {WKV_TRAIN} {str(r.dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
          f"{t['device_ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms none (no PyTorch "
          f"call computes the gradient) bound_ms {t['bound_ms']:.4f} (by {t['bound_by']}: "
          f"{moved} bytes, {flops} FLOP, peak {PEAK_FLOP_S[r.dtype]:.3g} FLOP/s); this "
          f"design's {wkv_bwd_tc_flops(r)} FLOP on TF32 mma.sync take "
          f"{wkv_bwd_tc_flops(r) / H100_TF32_FLOP_S * 1e3:.4f} ms at the TF32 peak "
          f"({H100_TF32_FLOP_S:.3g} FLOP/s)")
    return times


def check_train_parity(arch: str, num_layers: int) -> float:
    """Same f32 weights on the card (kernels, forward and backward) and on
    the CPU (plain versions): loss and every gradient within the stated
    bounds.  `arch` at its full width cut to `num_layers`; the card's run
    must launch each backward kernel of its layers once per layer."""
    cfg = dataclasses.replace(configs.get(arch), num_layers=num_layers, dtype="float32")
    if arch == "stablelm-3b":
        cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
    else:  # drawn on the card: a 256k x 4096 f32 table is slow to draw on the host
        gpu_model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        cpu_model = copy.deepcopy(gpu_model).to("cpu")
    data = SyntheticLM(cfg.vocab_size, 128, seed=SEED)
    batch = {k: torch.from_numpy(v) for k, v in data.global_batch(0, 2, 1).items()}
    losses = []
    reset_launches()
    for model in (gpu_model, cpu_model):
        loss, _ = loss_fn(cfg, model, {k: v.to(model.device) for k, v in batch.items()})
        loss.backward()
        losses.append(loss.item())
    launches, kinds = read_launches(), cfg.layer_kinds
    want = {"flash_attention_bwd_dkv": sum(k in ("attn", "local") for k in kinds),
            "rg_lru_bwd": kinds.count("rglru"), "wkv6_bwd": kinds.count("rwkv6")}
    got = {name: launches[name] for name in want}
    text = f"{arch} ({num_layers} layers {kinds}, f32, 2 x 128 tokens)"
    print(f"train parity {text}: loss card {losses[0]:.7f} cpu {losses[1]:.7f}; backward "
          f"launches on the card {got}")
    if got != want:
        raise AssertionError(f"{text}: backward launches {got}, expected {want}")
    if not math.isclose(losses[0], losses[1], rel_tol=TRAIN_LOSS_RTOL):
        raise AssertionError(f"card and CPU losses differ beyond rtol {TRAIN_LOSS_RTOL}")
    worst, worst_leaf = 0.0, None
    for (name, pg), (_, pc) in zip(gpu_model.named_parameters(), cpu_model.named_parameters(),
                                   strict=True):
        rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_leaf = rel, name
        if not rel <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"gradient {name}: card vs CPU relative error {rel:.3e}")
    print(f"train parity {text} gradients: worst per-leaf ||card - cpu|| / ||cpu|| "
          f"{worst:.3e} at {worst_leaf} (tol {TRAIN_GRAD_RTOL}) over "
          f"{len(list(cpu_model.parameters()))} leaves")
    return worst


LAUNCH_COUNTERS = {
    "flash_attention_fwd": flash_kernel.flash_attention_fwd_lse,
    "flash_attention_bwd_dkv": flash_bwd.flash_attention_bwd_dkv,
    "flash_attention_bwd_dq": flash_bwd.flash_attention_bwd_dq,
    "rg_lru_fwd": lru_kernel.rg_lru_fwd,
    "wkv6_fwd": wkv_kernel.wkv6_fwd,
    "rg_lru_bwd": lru_kernel.rg_lru_bwd,
    "wkv6_bwd": wkv_kernel.wkv6_bwd,
}


# the kernels with a tensor-core (bf16) variant, counted apart in launches_tc
TC_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# the recurrences' designs, counted apart: B4's and B5's T = 1 kernels, B5's
# two-pass one (bf16, T > 1), B5''s chunked one (bf16), and B5' calls that
# walked the chunk-entry states themselves (no forward workspace)
DESIGN_COUNTERS = {"rg_lru_fwd": ("launches_step",),
                   "wkv6_fwd": ("launches_chunked", "launches_step"),
                   "wkv6_bwd": ("launches_chunked", "launches_entry")}


def reset_launches() -> None:
    for name, fn in LAUNCH_COUNTERS.items():
        fn.launches = 0
        if name in TC_COUNTERS:
            fn.launches_tc = 0
        for key in DESIGN_COUNTERS.get(name, ()):
            setattr(fn, key, 0)


def read_designs() -> dict:
    return {name: {key: getattr(LAUNCH_COUNTERS[name], key) for key in keys}
            for name, keys in DESIGN_COUNTERS.items()}


def read_launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def check_tensor_core_launches(path: str) -> None:
    """On a bf16 path every launch of B1, B2 and B3 is of the tensor-core variant."""
    counts = {name: (LAUNCH_COUNTERS[name].launches, LAUNCH_COUNTERS[name].launches_tc)
              for name in TC_COUNTERS}
    print(f"{path}: (launches, of which tensor-core) {counts}")
    if any(total != tc for total, tc in counts.values()):
        raise AssertionError(f"{path}: a bf16 launch of B1, B2 or B3 missed the "
                             f"tensor-core variant: {counts}")


def check_train_launches(path: str, kinds, steps: int, launches: dict, designs: dict) -> dict:
    """The launch counts of `steps` bf16 training steps of layers `kinds` at
    the training shape, checked; returns the counts a step."""
    attn = sum(k in ("attn", "local") for k in kinds)
    rglru, rwkv = kinds.count("rglru"), kinds.count("rwkv6")
    per_step = {"flash_attention_fwd": 2 * attn,   # forward + remat recompute
                "flash_attention_bwd_dkv": attn, "flash_attention_bwd_dq": attn,
                "rg_lru_fwd": 2 * rglru, "wkv6_fwd": 2 * rwkv,
                "rg_lru_bwd": rglru, "wkv6_bwd": rwkv}
    want = {k: v * steps for k, v in per_step.items()}
    # every B4 call in the ring (T = 512), every B5 call two-pass (bf16), and
    # every B5' call chunked (bf16), from the forward's chunk-entry states
    want_designs = {"rg_lru_fwd": {"launches_step": 0},
                    "wkv6_fwd": {"launches_chunked": want["wkv6_fwd"], "launches_step": 0},
                    "wkv6_bwd": {"launches_chunked": want["wkv6_bwd"], "launches_entry": 0}}
    if launches != want or designs != want_designs:
        raise AssertionError(f"{path}: launches {launches}, designs {designs}; "
                             f"expected {want}, {want_designs}")
    return per_step


def train_path(arch: str, num_layers: int | None) -> tuple[dict, list[float]]:
    """A main path: `arch` at its full published config (cut to `num_layers`
    where given, full width) trains TRAIN_STEPS steps through `train()`.
    Returns the launch counts of the run and its losses."""
    b, _, seq = TRAIN_CASE[0], TRAIN_CASE[1], TRAIN_CASE[2]
    tc = train_mod.TrainConfig(arch=arch, scale="full", steps=TRAIN_STEPS,
                               batch_size=b, seq_len=seq, grad_sync="bridge", seed=SEED)
    cfg = train_mod.model_config(tc)
    if (cfg.dtype, cfg.remat, cfg.remat_policy) != ("bfloat16", True, "full") \
            or cfg != configs.get(arch):
        raise AssertionError(f"not the full config: {cfg}")
    model = None
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    lines = []

    def progress(msg):
        lines.append(msg)
        print(msg, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trained, _, losses = train_mod.train(tc, progress=progress, device="cuda", model=model)
    launches, designs = read_launches(), read_designs()
    check_tensor_core_launches(f"train {arch}")
    peak = torch.cuda.max_memory_allocated()
    kinds = cfg.layer_kinds
    per_step = check_train_launches(f"train {arch}", kinds, TRAIN_STEPS, launches, designs)
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    dts = [float(re.search(r"dt ([0-9.]+)s", line).group(1)) for line in lines]
    timed = dts[1:]
    step_s = sum(timed) / len(timed)
    params = sum(p.numel() for p in trained.parameters())
    cut = "" if num_layers is None else \
        f" cut to {num_layers} of {configs.get(arch).num_layers} layers {kinds}"
    print(f"train {arch} full config{cut} "
          f"(bf16, remat full, grad_sync bridge, 1 rank, {params} parameters), batch {b} x "
          f"{seq}: losses {losses}, warm-up step {dts[0]:.4f} s, timed steps {timed} s, mean "
          f"{step_s:.4f} s = {b * seq / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes), launches {launches} (per step {per_step}), "
          f"designs {designs}")
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
    for mode in ("gspmd", "bridge"):
        got = res["train_losses"][mode]
        if not all(math.isclose(a, b, rel_tol=LOSS_RTOL) for a, b in zip(got, want, strict=True)):
            raise AssertionError(f"{n}-rank {mode} losses {got} differ from the one-rank "
                                 f"main path's {want} beyond rtol {LOSS_RTOL}")
    print(f"multi-card train: {n}-rank gspmd and bridge losses match the one-rank main "
          f"path's {want} (rtol {LOSS_RTOL})")
    return res


def host_ms(fn, iters: int) -> float:
    """ms of one call of the collective `fn` on the host clock, every rank
    starting together after a warm-up call and ending synchronised."""
    import torch.distributed as dist

    fn()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) / iters * 1e3


def multi_all_to_all(n: int, dev, say) -> dict:
    """bruck_all_to_all against dist.all_to_all_single at MULTI_SIZES_MB a
    rank (f32; row j of a rank's (n, m) input is its block for rank j): the
    same bits, then both timed on the host clock."""
    import torch.distributed as dist

    from repro_torch.collectives import bruck_all_to_all

    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + dist.get_rank())
    out = {}
    for mb in MULTI_SIZES_MB:
        x = torch.randn((n, mb * 2**20 // 4 // n), generator=gen, device=dev)
        want = torch.empty_like(x)
        dist.all_to_all_single(want, x)
        if not torch.equal(bruck_all_to_all(x), want):
            raise AssertionError(f"bruck_all_to_all {mb} MB differs from all_to_all_single")
        recv = torch.empty_like(x)
        ms = {"library": host_ms(lambda x=x: dist.all_to_all_single(recv, x), 5),
              "bruck": host_ms(lambda x=x: bruck_all_to_all(x), 5)}
        out[f"all_to_all_{mb}MB_ms"] = ms
        say(f"multi-card all-to-all {mb} MB f32 a rank on {n} ranks: bruck_all_to_all equals "
            f"dist.all_to_all_single bit for bit; host clock, ms: {ms}")
    return out


def multi_compressed(n: int, dev, say) -> dict:
    """The reference's compressed all-reduce gates (tests/_multidevice_worker.py):
    round 1's relative error below 0.05, and with error feedback round 1 +
    round 2 within 2 x round 1's error of twice the sum; then the compressed
    all-reduce and dist.all_reduce timed at MULTI_SIZES_MB a rank."""
    import torch.distributed as dist

    from repro_torch.collectives import compressed_all_reduce, make_error_feedback_state

    rank = dist.get_rank()
    g = torch.randn((n, 33), generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev) * 3.0   # every rank draws the same global array
    want = g.sum(0)
    grads = [g[rank].clone()]
    ef = make_error_feedback_state(grads)
    (out1,), ef = compressed_all_reduce(grads, ef)
    (out2,), _ = compressed_all_reduce(grads, ef)
    err1 = (out1 - want).abs().max().item()
    rel = err1 / want.abs().max().item()
    err_fb = (out1 + out2 - 2 * want).abs().max().item()
    say(f"multi-card compressed all-reduce on {n} ranks: relative error {rel:.4e} (gate "
        f"< 0.05); error feedback {err_fb:.4e} <= 2 x {err1:.4e} + 1e-6")
    if not (rel < 0.05 and err_fb <= 2 * err1 + 1e-6):
        raise AssertionError("compressed all-reduce gates failed")
    out = {"compressed_gates": {"rel_err": rel, "err1": err1, "err_fb": err_fb}}
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    for mb in MULTI_SIZES_MB:
        x = torch.randn(mb * 2**20 // 4, generator=gen, device=dev)
        zero = make_error_feedback_state([x])
        ms = {"library": host_ms(lambda x=x: dist.all_reduce(x.clone()), 5),
              "compressed": host_ms(lambda x=x, z=zero: compressed_all_reduce([x], z), 5)}
        out[f"compressed_allreduce_{mb}MB_ms"] = ms
        say(f"multi-card compressed all-reduce {mb} MB f32 on {n} ranks (host clock, ms): {ms}")
    return out


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
        out.update(multi_all_to_all(n, dev, say))
        out.update(multi_compressed(n, dev, say))
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
        for mode in train_mod.GRAD_SYNCS:
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
            + ", ".join(f"{mode} {losses[mode]} (steps {step_s[mode]} s)" for mode in losses)
            + f" (bridge vs gspmd rtol {LOSS_RTOL})")
        if not all(math.isclose(a, c, rel_tol=LOSS_RTOL)
                   for a, c in zip(losses["bridge"], losses["gspmd"], strict=True)):
            raise AssertionError("bridge and gspmd losses differ")
        # tests/_distributed_worker.py check 2: compressed sync still trains
        compressed = losses["bridge-compressed"]
        if not (all(math.isfinite(x) for x in compressed) and compressed[-1] < 1.5 * compressed[0]):
            raise AssertionError(f"bridge-compressed losses {compressed} not finite or diverging")
        say(json.dumps(out))
    finally:
        dist.destroy_process_group()


# --- phase 10: the fabric playback (B6) ---------------------------------------------

SIM_M = 4 * 2**20          # the reference's sim_bench payload, 4 MiB
SIM_DELTA = 1e-3           # and its reconfiguration delay
SIM_KINDS = ("a2a", "rs", "ag")
PLAYBACK_GRID = [(n, r) for n in (6, 12, 48, 96, 97) for r in (2, 3)]
PLAYBACK_CHUNKS = (1, 4, 8)
PLAYBACK_DELTAS = (0.0, 1e-3)
# B6's layout (`launch_plan`): forced cluster sizes at n = 1536; each place
# of the trains, (comp, CTAs), at n = 97; the plan's steps from one CTA to
# two and a C the register kernels do not take, (n, C, CTAs)
PLAYBACK_CLUSTERS = (1, 2, 3, 4, 8, 16)
PLAYBACK_PLACEMENTS = [(comp, cluster) for comp in ("registers", "shared", "global")
                       for cluster in (1, 5)]
PLAYBACK_STEPS = [(1024, 16, 1), (1025, 16, 2), (2048, 8, 1), (2049, 8, 2), (4096, 2, 1),
                  (4097, 2, 2), (1536, 3, 1)]
# the reference's tiers (benchmarks/sim_bench.py): n, lanes, chunks, hop cap;
# "jax" is its NumPy-vs-XLA tier, the two others its "jax-scale" ones
SIM_TIERS = {"jax": (1536, 256, 4, 300), "jax-scale 8192": (8192, 64, 2, 400),
             "jax-scale 32768": (32768, 32, 2, 600)}
PLAN_NS = (1536, 32768)    # the planner's ocs-sim path, NumPy beside it at the first
CROSSOVER_NS = (2, 3, 4, 6, 12, 24, 48, 96, 192, 384)
# FP64 outside the tensor cores (NVIDIA H100 SXM data sheet; max and add are
# not FMAs, so B6 cannot use the FP64 tensor cores)
H100_F64_FLOP_S = 34e12
# the fewest cycles an SM makes a dependent instruction wait: a floor for
# each link of B6's serial chain (a max, an add, or a hop's barrier), not a
# measurement
DEPENDENT_CYCLES = 4


def candidate_lanes(n: int, m: float, r: int = 2) -> list:
    """The deduped a2a / rs / ag candidate set at (n, r) as BatchLanes (one
    shared S: one batch), as the reference's sim_bench builds it
    (`benchmarks/sim_bench.py:_candidate_lanes`)."""
    seen, lanes = set(), []
    for kind in SIM_KINDS:
        for _, sched in schedules.candidate_schedules(kind, n, m, PAPER_DEFAULT, r=r):
            if (sched.kind, sched.x) not in seen:
                seen.add((sched.kind, sched.x))
                lanes.append(batchsim.BatchLane(schedule=sched, m_bytes=m))
    return lanes


def tier_lanes(n: int, m: float, lanes_target: int, hop_cap: int) -> list:
    """The reference's wide certified lane set (`sim_bench.py:_jax_lanes`):
    the candidates of at most `hop_cap` hops, tiled with a 1 % payload ramp
    out to `lanes_target` lanes."""
    base = [lane for lane in candidate_lanes(n, m)
            if sum(batchsim.compile_tape(lane.schedule).hops) <= hop_cap]
    lanes, rep = [], 0
    while len(lanes) < lanes_target:
        lanes += [batchsim.BatchLane(schedule=lane.schedule, m_bytes=m * (1.0 + 0.01 * rep))
                  for lane in base]
        rep += 1
    return lanes[:lanes_target]


def playback_inputs(lanes, cm, C: int):
    """B6's inputs on the card for `lanes`, as `batch_run` and
    `play_certified` build them: ((nb, g, hops, changed, delta_eff), the
    wrapper's keywords, the hops as numpy)."""
    tapes = [batchsim.compile_tape(lane.schedule) for lane in lanes]
    n = tapes[0].n
    m = np.array([lane.m_bytes for lane in lanes])
    nb = (m[:, None] * np.stack([t.arrays["counts"] for t in tapes])) / n
    hops = np.stack([t.arrays["hops"] for t in tapes])
    changed = np.stack([t.arrays["changed_pay"] for t in tapes]).copy()
    changed[:, 0] = False
    delta_eff = batchsim._knob_arrays(lanes, cm, n)[2]
    arrays = ((nb, np.float64), (np.stack([t.arrays["g_step"] for t in tapes]), np.int32),
              (hops, np.int32), (changed, np.uint8), (delta_eff, np.float64))
    args = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).cuda() for a, dt in arrays)
    kw = {"n": n, "C": C, "alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h, "beta": cm.beta}
    return args, kw, hops


def check_playback_call(args, kw, label: str, plan=None) -> None:
    """B6 (on `plan`, None: its own layout) against its plain version on the
    card: the same bits, and the same bits in a second run."""
    got = playback_kernel.fabric_playback(*args, **kw, _plan=plan)
    again = playback_kernel.fabric_playback(*args, **kw, _plan=plan)
    torch.cuda.synchronize()
    want = playback_ref.fabric_playback(*args, **kw)
    same = all(torch.equal(a, w) for a, w in zip(got, want, strict=True))
    stable = all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    plan = plan or playback_kernel.launch_plan(kw["n"], kw["C"])
    line = (f"fabric_playback {label} (B {args[0].shape[0]}, S {args[0].shape[1]}, n "
            f"{kw['n']}, C {kw['C']}; {plan.cluster} CTAs of {plan.threads}, trains in "
            f"{plan.comp}) inputs {input_hash(*args)}: bit-identical to the plain version "
            f"{same}, two runs {stable}, finite {finite}")
    print(line)
    if not (same and stable and finite):
        raise AssertionError(f"B6 disagrees with its plain version: {line}")


def seeded_lanes(n: int, r: int, rng, hop_cap: int | None = None) -> list:
    """The candidate set at (n, r) (those of at most `hop_cap` hops) with
    seeded payloads, and a zero-payload lane."""
    lanes = [batchsim.BatchLane(schedule=lane.schedule,
                                m_bytes=SIM_M * float(rng.uniform(0.05, 2.0)))
             for lane in candidate_lanes(n, SIM_M, r)
             if hop_cap is None or sum(batchsim.compile_tape(lane.schedule).hops) <= hop_cap]
    return lanes + [batchsim.BatchLane(schedule=lanes[0].schedule, m_bytes=0.0)]


def check_playback() -> None:
    """B6 against its plain version, bit for bit: on the deduped candidate
    sets of the grid with seeded payloads and a zero-payload lane, for every
    chunk count and delay; then at the layout's own points (PLAYBACK_CLUSTERS,
    PLAYBACK_PLACEMENTS, PLAYBACK_STEPS) and on tapes with offsets outside
    [0, n) and hop counts of 0 and below."""
    for n, r in PLAYBACK_GRID:
        lanes = seeded_lanes(n, r, np.random.default_rng(SEED + 100 * n + r))
        for C in PLAYBACK_CHUNKS:
            for delta in PLAYBACK_DELTAS:
                args, kw, _ = playback_inputs(lanes, PAPER_DEFAULT.replace(delta=delta), C)
                check_playback_call(args, kw, f"n={n} r={r} delta={delta}")
    cm = PAPER_DEFAULT.replace(delta=SIM_DELTA)
    rng = np.random.default_rng(SEED + 1536)
    args, kw, _ = playback_inputs(seeded_lanes(1536, 2, rng, hop_cap=300), cm, 4)
    for cluster in PLAYBACK_CLUSTERS:
        check_playback_call(args, kw, f"n=1536 on {cluster} CTAs",
                            playback_kernel.launch_plan(1536, 4, cluster=cluster))
    lanes = seeded_lanes(97, 3, rng)
    for C in (3, 8, 20):
        args, kw, _ = playback_inputs(lanes, cm, C)
        for comp, cluster in PLAYBACK_PLACEMENTS:
            if comp != "registers" or C in playback_kernel.REG_SLOTS:
                check_playback_call(args, kw, f"n=97 trains in {comp} on {cluster} CTAs",
                                    playback_kernel.launch_plan(97, C, cluster=cluster,
                                                                comp=comp))
    for n, C, cluster in PLAYBACK_STEPS:
        args, kw, _ = playback_inputs(seeded_lanes(n, 2, rng, hop_cap=64), cm, C)
        got = playback_kernel.launch_plan(n, C).cluster
        if got != cluster:
            raise AssertionError(f"launch_plan({n}, {C}) takes {got} CTAs, not {cluster}")
        check_playback_call(args, kw, f"n={n} (the plan's {cluster} CTAs)")
    n, B, S = 37, 5, 9
    hops = rng.integers(-3, 6, (B, S))
    hops[0] = 0                     # a lane that never hops
    arrays = ((rng.uniform(1e3, 1e6, (B, S)), np.float64),
              (rng.integers(-5 * n, 5 * n, (B, S)), np.int32), (hops, np.int32),
              (rng.integers(0, 2, (B, S)), np.uint8), (rng.uniform(0.0, 1e-3, B), np.float64))
    args = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).cuda() for a, dt in arrays)
    for cluster in (1, 5):
        kw = {"n": n, "C": 3, "alpha_s": cm.alpha_s, "alpha_h": cm.alpha_h, "beta": cm.beta}
        check_playback_call(args, kw, f"offsets outside [0, n), hops <= 0, {cluster} CTAs",
                            playback_kernel.launch_plan(n, 3, cluster=cluster))


def playback_bound(hops: np.ndarray, kw: dict, clock_hz: float) -> tuple[float, str, str]:
    """(least ms, "bytes" | "operations", how) for B6 on `hops` (B, S): the
    tapes read and the three outputs written once at the HBM rate; the FP64
    work (a max and an add a chunk service, n C sum(hops) services) at the
    FP64 peak; and the longest lane's serial chain (sum(hops) C dependent
    max-and-add pairs and a barrier a hop, DEPENDENT_CYCLES each, at the
    SM's maximum clock)."""
    n, C = kw["n"], kw["C"]
    B, S = hops.shape
    hops = np.maximum(hops, 0)
    moved = B * S * (8 + 4 + 4 + 1) + 8 * B + 8 * (2 * B * n + B * S)
    flops = 2 * n * C * int(hops.sum())
    t_bytes = moved / H100_HBM_BYTES_S * 1e3
    t_ops = flops / H100_F64_FLOP_S * 1e3
    links = int(hops.sum(axis=1).max()) * (2 * C + 1)
    t_chain = links * DEPENDENT_CYCLES / clock_hz * 1e3
    how = (f"{moved} bytes {t_bytes:.6f} ms, {flops} FP64 FLOP {t_ops:.6f} ms, chain of "
           f"{links} dependent links {t_chain:.6f} ms")
    return max(t_bytes, t_ops, t_chain), ("bytes" if t_bytes >= max(t_ops, t_chain)
                                          else "operations"), how


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def time_playback(args, kw, hops, clock_hz: float, label: str) -> dict:
    """B6 (`ms`, `device_ms`, median of three in turns) and its plain version
    on the card at one shape (in turns too; once where one call of it walks
    more than 4096 hops), beside the bound and B6's layout; no single
    PyTorch call computes the playback."""
    fns = {"ms": lambda: playback_kernel.fabric_playback(*args, **kw),
           "plain_ms": lambda: playback_ref.fabric_playback(*args, **kw)}
    fns["device_ms"] = fns["ms"]
    slow = int(hops.max()) > 4096
    if slow:
        plain = fns.pop("plain_ms")
    t = time_in_turns(fns, {}, {"ms": 10, "device_ms": 10, "plain_ms": 1})
    if slow:
        t["plain_ms"] = time_ms(plain, iters=1, warmup=0)
    t["bound_ms"], t["bound_by"], how = playback_bound(hops, kw, clock_hz)
    t["library_ms"] = t["library_device_ms"] = None
    plan = playback_kernel.launch_plan(kw["n"], kw["C"])
    t["layout"] = dict(dataclasses.asdict(plan),
                       max_active_clusters=playback_kernel.max_active_clusters(plan, kw["C"]))
    print(f"fabric_playback timing {label}: kernel_ms {t['ms']:.4f} device_ms "
          f"{t['device_ms']:.4f} plain_ms {t['plain_ms']:.4f}{' (one call)' if slow else ''} "
          f"library_ms none (no PyTorch call plays the tape) bound_ms {t['bound_ms']:.6f} "
          f"(by {t['bound_by']}: {how}); layout {t['layout']}")
    return t


BENCH_SIM = Path(__file__).resolve().parent / "BENCH_sim_scale.json"


def recorded_checksum(n: int):
    """The completion checksum BENCH_sim_scale.json records for the tier at n
    (the reference's XLA playback on a CPU), or None."""
    if not BENCH_SIM.exists():
        return None
    rows = json.loads(BENCH_SIM.read_text())["rows"]
    return next((row["completion_checksum"] for row in rows
                 if row["tier"] in ("jax", "jax-scale") and row["n"] == n), None)


def playback_tier(name: str, clock_hz: float) -> dict:
    """One of the reference's tiers: B6 against its plain version, then the
    path `batch_run(backend="torch")` with B6's launches counted (at the "jax"
    tier beside `batch_run(backend="numpy")`, bit for bit), the checksum
    beside the recorded one, and the timing."""
    n, B, C, cap = SIM_TIERS[name]
    cm = PAPER_DEFAULT.replace(delta=SIM_DELTA)
    t0 = time.perf_counter()
    lanes = tier_lanes(n, SIM_M, B, cap)
    args, kw, hops = playback_inputs(lanes, cm, C)
    print(f"fabric tier {name}: {len(lanes)} lanes of n {n}, C {C}, hop cap {cap}, sum(hops) "
          f"{int(hops.sum())} (longest lane {int(hops.sum(axis=1).max())}), built in "
          f"{time.perf_counter() - t0:.2f} s")
    check_playback_call(args, kw, f"tier {name}")
    numpy_s = None
    if name == "jax":
        t0 = time.perf_counter()
        want = batchsim.batch_run(lanes, cm, chunks_per_msg=C, backend="numpy")
        numpy_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    playback_kernel.fabric_playback.launches = 0
    t0 = time.perf_counter()
    got = batchsim.batch_run(lanes, cm, chunks_per_msg=C, backend="torch")
    torch_s = time.perf_counter() - t0
    launches = playback_kernel.fabric_playback.launches
    if got.backend != "torch" or not got.certified.all() or launches != 1:
        raise AssertionError(f"tier {name}: backend {got.backend}, certified "
                             f"{int(got.certified.sum())} of {len(lanes)}, B6 launches {launches}")
    if not (np.isfinite(got.completion).all() and got.node_done.shape == (len(lanes), n)):
        raise AssertionError(f"tier {name}: completions not finite or of the wrong shape")
    line = f"fabric tier {name}: batch_run torch {torch_s:.4f} s (B6 launches {launches})"
    if numpy_s is not None:
        same = all(np.array_equal(getattr(got, f), getattr(want, f))
                   for f in ("node_done", "step_done", "completion"))
        line += f", numpy {numpy_s:.4f} s on the host CPU, bit-identical {same}"
        if not same:
            raise AssertionError(f"tier {name}: the card's batch_run differs from NumPy's")
    checksum, recorded = float(got.completion.sum()), recorded_checksum(n)
    print(f"{line}; completion checksum {checksum!r} (BENCH_sim_scale.json {recorded!r}, "
          f"equal {checksum == recorded})")
    t = time_playback(args, kw, hops, clock_hz, f"tier {name}")
    t.update(numpy_ms=None if numpy_s is None else numpy_s * 1e3, batch_run_ms=torch_s * 1e3)
    return {"launches": launches, "shape": [len(lanes), int(hops.shape[1]), n, C],
            "times": t}


# the planner's arms on the ocs-sim path: the default Planner() verifies each
# plan on the host and (sim_backend "auto") plays its candidates on the card
PLANNER_ARMS = {"verified": dict, "unverified": lambda: {"verify": False},
                "numpy": lambda: {"sim_backend": "numpy"}}


def playback_planner(clock_hz: float) -> dict:
    """The planner's ocs-sim path: the default `Planner()` (verified, B6 on
    the card) plans each collective at PLAN_NS with B6's launches counted, in
    turns with `Planner(verify=False)` (verified, unverified, unverified,
    verified) and at the first n with `sim_backend="numpy"` around them; every
    plan of a collective is the same (`to_dict()`: schedule, predicted time,
    breakdown and the alternatives' scores).  The verifier's caches are
    cleared before each plan, and `verify_plan` is timed alone on the plan
    (caches cleared).  Holds B6 to its plain version and times it at each n's
    a2a candidate set (its static candidate walks n - 1 hops), and returns
    both paths for the kernels line."""
    cm = PAPER_DEFAULT.replace(delta=SIM_DELTA)
    out = {}
    for n in PLAN_NS:
        launches = 0
        secs = {arm: [] for arm in PLANNER_ARMS}
        verify_s = []
        for kind in SIM_KINDS:
            req = PlanRequest(kind=kind, n=n, m_bytes=SIM_M, cost_model=cm,
                              fabric=FabricKind.OCS_SIM)
            order = ("verified", "unverified", "unverified", "verified")
            if n == PLAN_NS[0]:
                order = ("numpy", *order, "numpy")
            plans = {}
            for arm in order:
                clear_verifier_caches()
                torch.cuda.synchronize()
                first = arm == "verified" and arm not in plans
                if first:
                    playback_kernel.fabric_playback.launches = 0
                t0 = time.perf_counter()
                res = Planner(**PLANNER_ARMS[arm]()).plan(req)
                torch.cuda.synchronize()
                secs[arm].append(time.perf_counter() - t0)
                if first:
                    launches += playback_kernel.fabric_playback.launches
                if plans and res.to_dict() != next(iter(plans.values())).to_dict():
                    raise AssertionError(f"plan {kind} n={n}: the {arm} plan differs from "
                                         f"the {next(iter(plans))} one")
                plans.setdefault(arm, res)
            got = plans["verified"]
            clear_verifier_caches()
            t0 = time.perf_counter()
            found = verify_plan(got)
            verify_s.append(time.perf_counter() - t0)
            if found:
                raise AssertionError(f"plan {kind} n={n}: verify_plan found {found}")
            print(f"plan ocs-sim {kind} n={n}: x {''.join(map(str, got.schedule.x))} "
                  f"{got.strategy} predicted {got.predicted_time!r}, {len(got.alternatives)} "
                  f"alternatives; verified, unverified"
                  f"{' and sim_backend numpy' if 'numpy' in plans else ''} plans equal")
        want_launches = len(SIM_KINDS)
        if launches != want_launches:
            raise AssertionError(f"plan ocs-sim n={n}: B6 launches {launches}, expected "
                                 f"{want_launches} (one a collective)")
        med = {arm: sorted(x)[len(x) // 2] for arm, x in secs.items() if x}
        print(f"plan ocs-sim n={n} (a2a, rs, ag; fresh planners, verifier caches cleared, "
              f"host clock, s): verified {[round(x, 4) for x in secs['verified']]}, "
              f"unverified {[round(x, 4) for x in secs['unverified']]}" + (
                  f", numpy {[round(x, 4) for x in secs['numpy']]}" if secs["numpy"] else "")
              + f"; verify_plan alone {[round(x, 4) for x in verify_s]}; median verified "
              f"{med['verified']:.4f}, unverified {med['unverified']:.4f}, ratio "
              f"{med['verified'] / med['unverified']:.3f}")
        lanes = [batchsim.BatchLane(schedule=sched, m_bytes=SIM_M)
                 for _, sched in schedules.candidate_schedules("a2a", n, SIM_M, cm)]
        C = Planner().sim_chunks
        args, kw, hops = playback_inputs(lanes, cm, C)
        check_playback_call(args, kw, f"plan a2a n={n}")
        t = time_playback(args, kw, hops, clock_hz, f"plan a2a n={n}")
        t.update(plan_verified_s=secs["verified"], plan_unverified_s=secs["unverified"],
                 plan_numpy_s=secs["numpy"], verify_plan_s=verify_s)
        out[n] = {"launches": launches, "shape": [len(lanes), int(hops.shape[1]), n, C],
                  "times": t}
    return out


def playback_crossover() -> float:
    """NumPy's `batch_run` against the card's, whole calls (certificates,
    tapes, copies and host round trips included), median of three each, on
    the deduped candidate sets at CROSSOVER_NS with the planner's 8 chunks.
    Returns the certified work (C n sum(hops)) from which on the card was
    faster at every larger size measured."""
    cm = PAPER_DEFAULT.replace(delta=SIM_DELTA)
    rows = []
    for n in CROSSOVER_NS:
        lanes = candidate_lanes(n, SIM_M)
        secs = {"numpy": [], "torch": []}
        for backend in ("numpy", "torch", "torch", "numpy", "numpy", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batchsim.batch_run(lanes, cm, chunks_per_msg=8, backend=backend)
            secs[backend].append(time.perf_counter() - t0)
        hops = np.stack([batchsim.compile_tape(lane.schedule).arrays["hops"] for lane in lanes])
        work = 8 * n * float(hops[res.certified].sum())
        t_np, t_torch = (sorted(secs[b])[1] for b in ("numpy", "torch"))
        rows.append((work, t_np, t_torch))
        print(f"crossover n={n}: {len(lanes)} lanes, certified work {work:.4g}: numpy "
              f"{t_np * 1e3:.3f} ms, torch {t_torch * 1e3:.3f} ms (host clock, median of 3)")
    faster = [t_torch < t_np for _, t_np, t_torch in rows]
    first = next((i for i in range(len(rows)) if all(faster[i:])), None)
    crossover = float("inf") if first is None else rows[first][0]
    print(f"crossover: the card's batch_run is faster from certified work {crossover:.4g} on "
          f"(batchsim._AUTO_MIN_WORK is {batchsim._AUTO_MIN_WORK:.4g})")
    return crossover


# --- phase 11: checkpointed training restart, and the workloads ---------------------

RESTART_ARCHS = ("stablelm-3b", "rwkv6-3b")   # each at full width cut to 2 layers
RESTART_LAYERS = 2
RESTART_STEPS = 4        # straight; the checkpointed run stops at 2 and resumes for 3-4
RESTART_EVERY = 2
RESTART_RTOL = 1e-4      # the reference's bound (tests/test_fault_tolerance.py:143-144)
BENCH_DIR = Path(__file__).resolve().parent
WORKLOAD_REL = 1e-12     # port row against the committed row
# one grid point of each workload bench (benchmarks/*_bench.py)
TRACE_POINT = ("mixed", 16, 1e-3)                 # trace_bench: trace, n, delta
ONLINE_POINT = ("mixed", 16, 1e-3, 2)             # online_bench: trace, n, delta, window
FAULT_POINT = ("link-down", 12, 1e-3, 0.5)        # faults_bench: kind, n, delta, fail_frac
TENANCY_POINT = ("port-partition", 2, 16, 1e-3)   # tenancy_bench: sharing, K, n, delta
STORM_N, STORM_WINDOW, STORM_REQUESTS = 16, 3, 256  # online_bench's storm


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def restart_path(arch: str) -> dict:
    """Checkpointed training restart through `train()`: `arch` at full width
    cut to RESTART_LAYERS, bf16, full remat, grad_sync "bridge", 8 x 512.
    RESTART_STEPS straight steps; then RESTART_EVERY steps that save a
    checkpoint, and a fresh `train()` on the same directory that resumes and
    runs the rest (saving nothing), its launches counted a step.  The
    resumed losses must equal the straight run's at RESTART_RTOL; whether they and the final
    parameters are bit-identical is printed.  The checkpoints go to a
    temporary directory, deleted afterwards."""
    b, _, seq = TRAIN_CASE[0], TRAIN_CASE[1], TRAIN_CASE[2]
    tc = train_mod.TrainConfig(arch=arch, scale="full", steps=RESTART_STEPS, batch_size=b,
                               seq_len=seq, grad_sync="bridge", seed=SEED)
    cfg = train_mod.model_config(tc)
    if (cfg.dtype, cfg.remat, cfg.remat_policy) != ("bfloat16", True, "full") \
            or cfg != configs.get(arch):
        raise AssertionError(f"not the full config: {cfg}")
    cfg = dataclasses.replace(cfg, num_layers=RESTART_LAYERS)

    def fresh():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")

    model, _, straight = train_mod.train(tc, progress=lambda *_: None, device="cuda",
                                         model=fresh())
    want_params = [p.detach().cpu() for p in model.parameters()]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        free = shutil.disk_usage(d).free
        first = dataclasses.replace(tc, steps=RESTART_EVERY, checkpoint_dir=d,
                                    checkpoint_every=RESTART_EVERY)
        _, _, part1 = train_mod.train(first, progress=lines.append, device="cuda",
                                      model=fresh())
        ckpt_bytes = dir_bytes(os.path.join(d, f"step_{RESTART_EVERY:08d}"))
        gc.collect()
        torch.cuda.empty_cache()
        model = fresh()
        torch.cuda.synchronize()
        reset_launches()
        # the default checkpoint_every (10) saves nothing in the resumed steps
        second = dataclasses.replace(tc, checkpoint_dir=d)
        model, opt_state, part2 = train_mod.train(second, progress=lines.append,
                                                  device="cuda", model=model)
        launches, designs = read_launches(), read_designs()
    for line in lines:
        print(f"restart {arch}: {line}")
    resumed = [line for line in lines if line.startswith("resumed from step")]
    if len(resumed) != 1 or not resumed[0].startswith(f"resumed from step {RESTART_EVERY} "):
        raise AssertionError(f"restart {arch}: expected one resume from step "
                             f"{RESTART_EVERY}, got {resumed}")
    seconds = [float(x) for x in re.findall(r"\(([0-9.]+) s\)", "\n".join(lines))]
    check_tensor_core_launches(f"restart {arch}")
    per_step = check_train_launches(f"restart {arch}", cfg.layer_kinds,
                                    RESTART_STEPS - RESTART_EVERY, launches, designs)
    if int(opt_state.step) != RESTART_STEPS or opt_state.step.device.type != "cuda":
        raise AssertionError(f"restart {arch}: AdamW step {opt_state.step}")
    got = part1 + part2
    if len(got) != RESTART_STEPS or not all(math.isfinite(x) for x in got):
        raise AssertionError(f"restart {arch}: losses {got}")
    if not np.allclose(got, straight, rtol=RESTART_RTOL, atol=0.0):
        raise AssertionError(f"restart {arch}: losses {got} against the straight run's "
                             f"{straight} beyond rtol {RESTART_RTOL}")
    same_params = all(torch.equal(p.detach().cpu(), w)
                      for p, w in zip(model.parameters(), want_params, strict=True))
    print(f"restart {arch} ({RESTART_LAYERS} layers {cfg.layer_kinds}, bf16, remat full, "
          f"grad_sync bridge, {b} x {seq}): straight losses {straight}, checkpointed "
          f"{part1} + resumed {part2}; equal at rtol {RESTART_RTOL}; losses bit-identical "
          f"{got == straight}, final parameters bit-identical {same_params}; checkpoint "
          f"{ckpt_bytes} bytes, save / restore seconds {seconds} (free on the "
          f"temporary directory's disk before: {free} bytes); resumed launches {launches} "
          f"(per step {per_step})")
    return {"launches": launches, "checkpoint_bytes": ckpt_bytes, "seconds": seconds,
            "bit_identical": got == straight and same_params}


def rows_differ(got, want, path: str = "") -> list[str]:
    """Where `got` and `want` (rows of a bench file) differ: numbers beyond
    WORKLOAD_REL relative, anything else at all."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else got} "
                    f"against {sorted(want)}"]
        return [d for k in want for d in rows_differ(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path}: {got} against {want}"]
        return [d for i, (g, w) in enumerate(zip(got, want)) for d in
                rows_differ(g, w, f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, (int, float)) \
            and not isinstance(got, bool):
        ok = abs(got - want) <= WORKLOAD_REL * max(abs(got), abs(want))
        return [] if ok else [f"{path}: {got!r} against {want!r}"]
    return [] if got == want and type(got) is type(want) else [f"{path}: {got!r} against "
                                                               f"{want!r}"]


def committed_row(bench: str, match: dict) -> dict:
    rows = [row for row in json.loads((BENCH_DIR / bench).read_text())["rows"]
            if all(row.get(k) == v for k, v in match.items())]
    if len(rows) != 1:
        raise AssertionError(f"{bench}: {len(rows)} rows match {match}")
    return rows[0]


def bench_trace(name: str, n: int, seed: int = 0):
    """The traces of benchmarks/trace_bench.py's make_trace."""
    return {"moe": lambda: workloads.moe_a2a_trace(n, layers=3, seed=seed),
            "train": lambda: workloads.train_step_trace(n, steps=2, buckets=2, seed=seed),
            "decode": lambda: workloads.decode_ag_trace(n, decode_steps=6, seed=seed,
                                                        jitter=0.25),
            "mixed": lambda: workloads.mixed_trace(n, seed=seed)}[name]()


def trace_row(name: str, n: int, delta: float) -> dict:
    """benchmarks/trace_bench.py's row, from the port."""
    trace = bench_trace(name, n)
    cm = PAPER_DEFAULT.replace(delta=delta)
    static, cold, carry = (workloads.plan_trace(trace, cm, mode=mode)
                           for mode in ("static", "cold", "carryover"))
    exec_carry = FabricSim(chunks_per_msg=4, mode="batched").run_trace(
        carry.fabric_phases(), cm)
    exec_cold = FabricSim(chunks_per_msg=4, mode="full-pause").run_trace(
        cold.fabric_phases(), cm)
    return {"trace": name, "n": n, "delta": delta, "events": len(trace),
            "phases": len(carry.phases), "total_mb": round(trace.total_bytes() / 1024.0 ** 2, 3),
            "static_s": static.total_time, "cold_fabric_s": cold.total_time,
            "carryover_s": carry.total_time,
            "carryover_vs_cold": round(cold.total_time / carry.total_time, 6),
            "carryover_vs_static": round(static.total_time / carry.total_time, 6),
            "free_boundaries": carry.free_boundaries, "boundaries": len(carry.boundary_cost),
            "carry_paid_reconfigs": carry.paid_reconfigs,
            "exec_carry_sparse_s": exec_carry.completion,
            "exec_cold_fullpause_s": exec_cold.completion}


def online_row(name: str, n: int, delta: float, window: int) -> dict:
    """benchmarks/online_bench.py's grid row, from the port."""
    trace = bench_trace(name, n)
    cm = PAPER_DEFAULT.replace(delta=delta)
    offline = workloads.plan_trace(trace, cm, mode="carryover")
    cold = workloads.plan_trace(trace, cm, mode="cold")
    online, stats = workloads.run_online(trace, cm, window=window)
    return {"trace": name, "n": n, "delta": delta, "window": window, "events": len(trace),
            "phases": len(online.phases), "online_s": online.total_time,
            "offline_s": offline.total_time, "cold_event_s": cold.total_time,
            "online_vs_offline": round(online.total_time / offline.total_time, 6),
            "cold_vs_online": round(cold.total_time / online.total_time, 6),
            "replans": stats.replans, "plan_reuses": stats.plan_reuses,
            "free_boundaries": online.free_boundaries, "paid_reconfigs": online.paid_reconfigs}


def fault_row(kind: str, n: int, delta: float, fail_frac: float) -> dict:
    """benchmarks/faults_bench.py's row (its recovery_for, verified), from the port."""
    cm = PAPER_DEFAULT.replace(delta=delta)
    trace = workloads.mixed_trace(n, moe_layers=1, train_steps=1, decode_steps=3)
    plan = workloads.plan_trace(trace, cm, mode="carryover")
    chunks = 8
    clean = FabricSim(mode="sparse", chunks_per_msg=chunks).run_trace(plan.fabric_phases(), cm)
    node = n if kind == "node-join" else n // 3
    repair = 0.05 * clean.completion if kind == "link-flap" else 0.0
    faults = FaultTimeline(n=n, faults=(FaultSpec(kind=kind, time=fail_frac * clean.completion,
                                                  node=node, repair_s=repair),),
                           policy="requeue" if kind == "link-flap" else "drop")
    faults.check_horizon(clean.completion)
    rr = workloads.run_with_recovery(trace, cm, faults=faults, chunks_per_msg=chunks,
                                     verify=True)
    ds = rr.degraded
    return {"trace": "mixed", "kind": kind, "n": n, "delta": delta, "fail_frac": fail_frac,
            "policy": faults.policy, "fault_time_s": faults.faults[0].time,
            "completed_phases": ds.completed_phases,
            "committed_events": len(rr.committed_events), "new_n": ds.new_n,
            "committed_chunks": ds.committed_chunks, "lost_chunks": ds.lost_chunks,
            "requeued_chunks": ds.requeued_chunks, "recovery_total_s": rr.recovery_total,
            "restart_total_s": rr.restart_total,
            "recovery_ratio": round(rr.recovery_ratio, 6), "bit_identical": rr.bit_identical,
            "mispredictions": rr.stats.mispredictions}


def tenancy_row(sharing: str, K: int, n: int, delta: float) -> dict:
    """benchmarks/tenancy_bench.py's row (its make_tenants), from the port."""
    world = n if sharing == "time-slice" else n // K
    gens = (lambda w, s: workloads.mixed_trace(w, seed=s),
            lambda w, s: workloads.decode_ag_trace(w, decode_steps=4, seed=s, jitter=0.25),
            lambda w, s: workloads.moe_a2a_trace(w, layers=2, seed=s))
    weights = (2.0, 1.0, 1.5)
    tenants = tuple(workloads.TenantSpec(
        name=f"job-{i}", trace=gens[i % len(gens)](world, i), weight=weights[i % len(weights)],
        port_share=None if sharing == "time-slice" else 1.0 / K) for i in range(K))
    cm = PAPER_DEFAULT.replace(delta=delta)
    sp = workloads.plan_shared(workloads.SharedFabricRequest(
        tenants=tenants, n=n, cost_model=cm, sharing=SharingMode(sharing)))
    exec_s = None
    if sharing == "time-slice":
        exec_s = FabricSim(chunks_per_msg=4, mode="sparse").run_trace(
            sp.fabric_phases(), cm).completion
    return {"sharing": sharing, "K": K, "n": n, "delta": delta, "phases": len(sp.phases),
            "shared_s": sp.makespan_s, "weighted_s": sp.weighted_completion_s,
            "serialized_s": sp.serialized_s, "serialized_weighted_s": sp.serialized_weighted_s,
            "win_vs_serialized": round(sp.serialized_s / sp.makespan_s, 6),
            "weighted_win": round(sp.serialized_weighted_s / sp.weighted_completion_s, 6),
            "isolation": {t.name: round(t.isolation, 6) for t in sp.tenants},
            "isolation_bound": {t.name: round(t.isolation_bound, 6) for t in sp.tenants},
            "exec_sparse_s": exec_s, "shared_plan": sp.to_dict()}


def workload_rows() -> dict:
    """One grid point of each workload bench re-derived by the port and held
    to the committed row at WORKLOAD_REL, with the bench's gates at that
    point; then the plan service answers online_bench's storm (its hit
    accounting and plan-sequence signature held to the committed row, its
    hot plans/s printed).  Host work: the workloads run NumPy, as the
    reference's do."""
    tol = 1 + 1e-9
    out = {}
    for bench, match, row_fn, point in (
            ("BENCH_trace.json", ("trace", "n", "delta"), trace_row, TRACE_POINT),
            ("BENCH_online.json", ("trace", "n", "delta", "window"), online_row, ONLINE_POINT),
            ("BENCH_faults.json", ("kind", "n", "delta", "fail_frac"), fault_row, FAULT_POINT),
            ("BENCH_tenancy.json", ("sharing", "K", "n", "delta"), tenancy_row,
             TENANCY_POINT)):
        t0 = time.perf_counter()
        got = row_fn(*point)
        secs = time.perf_counter() - t0
        want = committed_row(bench, dict(zip(match, point)))
        diffs = rows_differ(got, want)
        if diffs:
            raise AssertionError(f"{bench} {point}: the port's row differs: {diffs[:5]}")
        out[bench] = got
        print(f"workload {bench} {dict(zip(match, point))}: the port's row equals the "
              f"committed one at rel {WORKLOAD_REL} ({len(got)} fields, {secs:.3f} s host)")
    trace, online = out["BENCH_trace.json"], out["BENCH_online.json"]
    faults, tenancy = out["BENCH_faults.json"], out["BENCH_tenancy.json"]
    gates = {
        "carryover <= cold": trace["carryover_s"] <= trace["cold_fabric_s"] * tol,
        "carryover <= static": trace["carryover_s"] <= trace["static_s"] * tol,
        "online >= offline": online["online_s"] >= online["offline_s"] * (1 - 1e-9),
        "online <= 1.10 x offline": online["online_s"] <= online["offline_s"] * 1.10,
        "recovery <= restart": faults["recovery_ratio"] <= tol,
        "recovery bit-identical": faults["bit_identical"],
        "port-partition isolation 1.0": all(abs(v - 1.0) <= 1e-9
                                            for v in tenancy["isolation"].values()),
    }
    print(f"workload gates: {gates}")
    if not all(gates.values()):
        raise AssertionError(f"a workload gate failed: {gates}")
    pool = workloads.build_request_pool(STORM_N, window=STORM_WINDOW, seed=0)
    service = workloads.PlanService()
    cold = workloads.request_storm(service, pool, requests=STORM_REQUESTS, seed=1)
    hot = workloads.request_storm(service, pool, requests=STORM_REQUESTS, seed=2)
    want = committed_row("BENCH_online.json", {"trace": "storm", "n": STORM_N})
    got = {"pool": len(pool), "cold_hits": cold.hits, "cold_misses": cold.misses,
           "hot_hits": hot.hits, "hot_misses": hot.misses, "unique_windows": cold.unique_windows}
    if any(got[k] != want[k] for k in got) or hot.hit_rate < 0.9:
        raise AssertionError(f"plan service storm: {got} against the committed {want}")
    # the signature hashes the served plans' floats as JSON: the last ulp moves it
    print(f"plan service: {STORM_REQUESTS} requests twice over a pool of {len(pool)} windows "
          f"(n={STORM_N}, W={STORM_WINDOW}): hits, misses and windows equal the committed "
          f"row's; cold {cold.plans_per_sec:.1f} plans/s, hot {hot.plans_per_sec:.1f} plans/s "
          f"(hit rate {hot.hit_rate:.4f}; host clock; the committed row, from another "
          f"machine: {want['hot_plans_per_sec']}); signature {hot.signature} (committed "
          f"{want['signature']}, equal {hot.signature == want['signature']})")
    return {"hot_plans_per_sec": hot.plans_per_sec}


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
    print_ptxas(_build.build_log())

    phase("3 kernels vs plain")
    fwd_errs = check_kernels()
    bwd_errs = check_bwd_kernels()
    rec_errs = check_recurrent_kernels()
    rec_errs.update(check_recurrent_bwd_kernels())
    phase("4 kernel timing")
    fwd_times = {case: time_flash(case)
                 for case in (TRAIN_FWD_CASE, SERVE_CASE, GRIFFIN_CASE, GRIFFIN_TRAIN_CASE,
                              QWEN_CASE, *NEW_CASES)}
    bwd_times = {case: time_bwd(case) for case in (TRAIN_CASE, GRIFFIN_BWD_CASE)}
    rec_times = time_recurrent()
    rec_times.update(time_recurrent_bwd())
    phase("5 model parity card vs cpu")
    for arch, num_layers in PARITY_ARCHS:
        check_model_parity(arch, num_layers)
        gc.collect()
    phase("6 train parity card vs cpu")
    for arch, num_layers in TRAIN_PARITY_ARCHS:
        check_train_parity(arch, num_layers)
        gc.collect()
    phase("7 serve")
    serve_launches = {}
    for arch in SERVE_ARCHS:  # one model at a time: each is freed before the next
        serve_launches[arch] = serve_path(arch)
        gc.collect()
        torch.cuda.empty_cache()
    phase("8 train (main path)")
    train_launches, train_losses = {}, {}
    for arch, num_layers in TRAIN_ARCHS:  # one model at a time
        train_launches[arch], train_losses[arch] = train_path(arch, num_layers)
        gc.collect()
        torch.cuda.empty_cache()
    phase("9 multi-card")
    if count >= 2:
        gc.collect()
        torch.cuda.empty_cache()  # rank 0 shares this card
        multi_card(min(4, count), train_losses["stablelm-3b"])
    else:
        print(f"multi-card phase: not run ({count} device)")
    phase("10 fabric playback")
    clock_hz = sm_clock_hz()
    check_playback()
    tiers = {name: playback_tier(name, clock_hz) for name in SIM_TIERS}
    plan_paths = playback_planner(clock_hz)
    playback_crossover()
    phase("11 checkpointed training restart, workloads")
    restarts = {}
    for arch in RESTART_ARCHS:  # one model at a time
        restarts[arch] = restart_path(arch)
        gc.collect()
        torch.cuda.empty_cache()
    workload_rows()

    kernels_dir = "src/repro/kernels"
    sources = {"flash_attention_fwd": ("flash_attention_fwd.cu",
                                       f"{kernels_dir}/flash_attention/kernel.py:35"),
               "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                           f"{kernels_dir}/flash_attention/kernel_bwd.py:48"),
               "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                                          f"{kernels_dir}/flash_attention/kernel_bwd.py:92"),
               "rg_lru_fwd": ("rg_lru.cu", f"{kernels_dir}/rg_lru/kernel.py:25"),
               "wkv6_fwd": ("wkv6.cu", f"{kernels_dir}/wkv6/kernel.py:34"),
               # no pallas_call: the JAX ops' custom_vjp backward
               "rg_lru_bwd": ("rg_lru.cu", f"{kernels_dir}/rg_lru/ops.py:24"),
               "wkv6_bwd": ("wkv6_bwd.cu", f"{kernels_dir}/wkv6/ops.py:25"),
               # no pallas_call: the reference's jitted XLA playback
               "fabric_playback": ("fabric_playback.cu", "src/repro/core/batchsim_jax.py:76")}
    # one entry per kernel and path: launches of that path's run, error and
    # times at the shape that path gives the kernel
    griffin, rwkv = serve_launches["recurrentgemma-9b"], serve_launches["rwkv6-3b"]
    stablelm, qwen = serve_launches["stablelm-3b"], serve_launches["qwen3-moe-235b-a22b"]
    whisper = serve_launches["whisper-base"]
    # whisper's prefill runs B1 at three shapes: the entry's numbers are the
    # encoder's, and the others ride along under other_shapes
    whisper_prefill = dict(fwd_times[WHISPER_ENC_CASE], other_shapes=[
        {"shape": list(case), "max_abs_err": fwd_errs[case], **fwd_times[case]}
        for case in (WHISPER_SELF_CASE, WHISPER_CROSS_CASE)])
    bwd_names = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    rwkv_train, griffin_train = train_launches["rwkv6-3b"], train_launches["recurrentgemma-9b"]
    entries = [
        ("train stablelm-3b", "flash_attention_fwd", TRAIN_FWD_CASE,
         train_launches["stablelm-3b"], fwd_errs[TRAIN_FWD_CASE], fwd_times[TRAIN_FWD_CASE]),
        *(("train stablelm-3b", name, TRAIN_CASE, train_launches["stablelm-3b"],
           bwd_errs[(name, TRAIN_CASE)], bwd_times[TRAIN_CASE][name]) for name in bwd_names),
        *(("train rwkv6-3b", name, WKV_TRAIN, rwkv_train, rec_errs[(name, WKV_TRAIN)],
           rec_times[(name, WKV_TRAIN)]) for name in ("wkv6_fwd", "wkv6_bwd")),
        *(("train recurrentgemma-9b", name, LRU_TRAIN, griffin_train,
           rec_errs[(name, LRU_TRAIN)], rec_times[(name, LRU_TRAIN)])
          for name in ("rg_lru_fwd", "rg_lru_bwd")),
        ("train recurrentgemma-9b", "flash_attention_fwd", GRIFFIN_TRAIN_CASE, griffin_train,
         fwd_errs[GRIFFIN_TRAIN_CASE], fwd_times[GRIFFIN_TRAIN_CASE]),
        *(("train recurrentgemma-9b", name, GRIFFIN_BWD_CASE, griffin_train,
           bwd_errs[(name, GRIFFIN_BWD_CASE)], bwd_times[GRIFFIN_BWD_CASE][name])
          for name in bwd_names),
        ("serve stablelm-3b prefill", "flash_attention_fwd", SERVE_CASE, stablelm["prefill"],
         fwd_errs[SERVE_CASE], fwd_times[SERVE_CASE]),
        ("serve recurrentgemma-9b prefill", "flash_attention_fwd", GRIFFIN_CASE,
         griffin["prefill"], fwd_errs[GRIFFIN_CASE], fwd_times[GRIFFIN_CASE]),
        ("serve qwen3-moe-235b-a22b prefill", "flash_attention_fwd", QWEN_CASE,
         qwen["prefill"], fwd_errs[QWEN_CASE], fwd_times[QWEN_CASE]),
        ("serve minicpm3-4b prefill", "flash_attention_fwd", MLA_CASE,
         serve_launches["minicpm3-4b"]["prefill"], fwd_errs[MLA_CASE], fwd_times[MLA_CASE]),
        ("serve whisper-base prefill", "flash_attention_fwd", WHISPER_ENC_CASE,
         whisper["prefill"], fwd_errs[WHISPER_ENC_CASE], whisper_prefill),
        ("serve whisper-base decode", "flash_attention_fwd", WHISPER_CROSS_DECODE,
         whisper["decode"], fwd_errs[WHISPER_CROSS_DECODE], fwd_times[WHISPER_CROSS_DECODE]),
        ("serve internvl2-26b prefill", "flash_attention_fwd", INTERNVL_CASE,
         serve_launches["internvl2-26b"]["prefill"], fwd_errs[INTERNVL_CASE],
         fwd_times[INTERNVL_CASE]),
        *((f"serve recurrentgemma-9b {part}", "rg_lru_fwd", case, griffin[part],
           rec_errs[("rg_lru_fwd", case)], rec_times[("rg_lru_fwd", case)])
          for part, case in (("prefill", LRU_PREFILL), ("decode", LRU_DECODE))),
        *((f"serve rwkv6-3b {part}", "wkv6_fwd", case, rwkv[part],
           rec_errs[("wkv6_fwd", case)], rec_times[("wkv6_fwd", case)])
          for part, case in (("prefill", WKV_PREFILL), ("decode", WKV_DECODE))),
        # B6 is bit-identical to its plain version wherever it is checked
        *((f"batch_run tier {name}", "fabric_playback", tuple(tier["shape"]),
           {"fabric_playback": tier["launches"]}, 0.0, tier["times"])
          for name, tier in tiers.items()),
        *((f"plan ocs-sim n={n} (verified)", "fabric_playback", tuple(path["shape"]),
           {"fabric_playback": path["launches"]}, 0.0, path["times"])
          for n, path in plan_paths.items()),
        # the resumed runs of phase 11 (their launches), at the training shapes
        ("train restart stablelm-3b", "flash_attention_fwd", TRAIN_FWD_CASE,
         restarts["stablelm-3b"]["launches"], fwd_errs[TRAIN_FWD_CASE],
         fwd_times[TRAIN_FWD_CASE]),
        *(("train restart stablelm-3b", name, TRAIN_CASE, restarts["stablelm-3b"]["launches"],
           bwd_errs[(name, TRAIN_CASE)], bwd_times[TRAIN_CASE][name]) for name in bwd_names),
        *(("train restart rwkv6-3b", name, WKV_TRAIN, restarts["rwkv6-3b"]["launches"],
           rec_errs[(name, WKV_TRAIN)], rec_times[(name, WKV_TRAIN)])
          for name in ("wkv6_fwd", "wkv6_bwd")),
    ]
    print(f"launches: serve {serve_launches}, train {train_launches}")
    kernels = [{
        "name": name,
        "path": path,
        "shape": list(case),
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources[name][0]}",
        "replaces": sources[name][1],
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

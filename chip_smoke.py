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
               positions; gemma3-4b's D = 256 GQA 2:1 at 1536 and 1000
               tokens, local and global; command-r-plus-104b's GQA 12:1 at
               D = 128) and the training shapes (minicpm3-4b's MLA at 8 x
               512, gemma3-4b's local and global layers at 2 x 2048), and
               ragged shapes; the backward B2 (dK/dV)
               and B3 (dQ) at the reference gradient shapes, the training
               shapes (minicpm3-4b's at D = 96 with V and dO zero past 64,
               as the op pads them; gemma3-4b's), ragged shapes (one at
               D = 96), a GQA case on several seeds and a
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
               B2, B3 (at stablelm-3b's training shape, and at minicpm3-4b's
               in both dtypes), B4's ring and B5's two-pass design are
               bit-identical over two runs.  The recurrences' backward B4' (RG-LRU) and
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
               `library_device_ms`), and its backend is recorded.  A window
               shorter than the keys goes to SDPA as a boolean mask; MLA's
               yardstick takes V of 64 as it is.
  5. parity  - at full width, f32, depth cut: stablelm-3b (4 layers),
               recurrentgemma-9b (one pattern period: rglru, rglru, local),
               rwkv6-3b (2 layers), qwen3-moe-235b-a22b (1 layer, ~15 GB),
               minicpm3-4b (2 layers), whisper-base whole (6 + 6 layers,
               1500 frames), internvl2-26b (1 layer, 64 patches) and
               gemma3-4b (5 local layers and the global one, its window cut
               to 100, so that the 128-token prefill masks and wraps the
               local ring and the decode steps read the wrapped ring):
               the same weights on the card (kernels) and on the CPU (plain
               versions) give the same prefill and decode logits; for the MoE
               arch it also prints how many (token, choice) routing decisions
               (expert and kept or dropped) agree between card and CPU, and
               the top-k probability gap of any token that differs.
  6. train parity - stablelm-3b, rwkv6-3b and minicpm3-4b (B2 and B3 at
               D = 96) at full width cut to 2 layers,
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
               the same loop; gemma3-4b whole twice past its 1024-token
               window (4 prompts of 1536 + 32 new tokens: the prefill
               outruns the window; 4 of 1000 + 64: the decode crosses the
               local ring's wrap), and command-r-plus-104b at full width
               cut to 12 of its 64 layers (~50.3 GB, GQA 12:1);
               the kernel launch counts of each run, in prefill and in decode,
               are read and checked (B1 once per attention or MLA layer in
               prefill, whisper's once per encoder layer and per cross
               attention in prefill and in every decode step, each in the
               tensor-core variant; B4 / B5 once per recurrent
               layer in prefill and in every decode step; every prefill call
               of B4 in the ring design and of B5 in the two-pass design,
               every decode call of both in the step kernel).  Each run
               is made twice, with the decode step captured once as a CUDA
               graph and replayed (`serve_requests`' default on the card:
               one eager warm-up step, the capture, a replay a token) and
               eagerly (graph=False): the ids equal, the launches of both
               checked.  The wrappers' counters see a captured run's
               warm-up step and its capture (which launches nothing), not
               its replays: so one more captured run, first, decodes under
               torch.profiler and its decode launches are its kernels'
               events counted by name (every replay's included), the
               launches the kernels line reports; the timed captured runs'
               counters must show the warm-up and the capture, one step's
               launches each; stablelm-3b, rwkv6-3b, recurrentgemma-9b, gemma3-4b
               and qwen3-moe alternate the two ways GRAPH_REPEATS times for
               the decode tok/s (and the replays' alone), beside each run's
               peak memory.  Then, from fresh prefills, the first replayed
               step's logits against the eager step's at the same position
               (bit for bit, else the largest difference printed; the ids
               equal), one eager decode step and one replay under
               torch.profiler (device ms, the device's idle share, host
               reads of device values, the top ops or, for the replay, the
               top kernels by device time; the replay must run B5's and
               B4's step kernels and B1's tensor-core one by name, as many
               times as one step launches them) and REPLAY_TIMED replays on the host clock;
               and the MoE arch's FFN is timed at the
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
               variant); minicpm3-4b whole (62 MLA layers: B1 124, B2 62, B3
               62 a step at D = 96) and gemma3-4b whole at 2 x 2048 (B1 68,
               B2 34, B3 34, its 29 local layers masked by their window).
               stablelm-3b and rwkv6-3b are trained a second time from the
               same seed under remat "dots" (a model whose config carries
               the policy, through `train()`'s model seam): the same
               launches, the losses against the "full" run's (bit for bit,
               else at rtol 1e-5), and one more backward of each run under
               torch.profiler counting its aten::mm and aten::bmm.  Then
               qwen3-moe-235b-a22b at full width cut to 1
               layer (3.73 G parameters, ~45 GB of state), gspmd, 2 steps,
               trained unsharded and then on a (1, 1) ("data", "model")
               mesh (parameters and moments as DTensor shards, gathered on
               use; the experts behind bruck_all_to_all over a group of
               one), one after the other: the same losses and final
               parameters bit for bit; B1 2, B2 1, B3 1 a step (D = 128,
               GQA 16:1, tensor-core) and 6 exchanges a group a step on
               the mesh.
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
               first.  With four cards the ranks then run the mesh paths
               (full width, bf16, full remat, gspmd, 8 x 512, 2 steps):
               qwen3-moe on a (2, 2) ("data", "model") mesh at 1 layer (its
               losses against phase 8's unsharded run at rtol 2e-4) and at
               4 layers (finite; each card's peak memory beside the
               reckoning; B1 8, B2 4, B3 4 a step and the exchanges
               counted), the expert-parallel exchange of one rank's 84 MB of
               slots timed through bruck_all_to_all beside
               all_to_all_single; recurrentgemma-9b whole (38 layers) on
               (4,) ('data',), its first loss against one card's forward
               loss_fn at rtol 1e-5, its launches against the layer
               pattern, each card's peak memory; GPipe (check 4 of
               tests/_distributed_worker.py): the reference's tanh stages
               at 1e-5, then stablelm-3b's 32 blocks as 4 stages of 8 over 4
               microbatches, forward, bit-identical to one card's
               sequential run of the same microbatches, B1 8 a microbatch a
               stage, both walls and the bubble; check 5: stablelm-3b (2
               layers) saved at step 2 on (4,), resumed on (2, 2) for steps
               3-4, against 4 straight steps on (4,) at rtol 2e-3, with the
               checkpoint's bytes and seconds.  Tensor parallelism over
               'model' and the rest of that axis: the
               vocab-parallel loss against the gathered logits' and the
               sequence-parallel step against the TP step (stablelm-3b, 2
               layers, f32, (2, 2) and (1, 4)); recurrentgemma-9b (2, 2)
               and rwkv6-3b (1, 4) whole with and without sequence
               parallelism, each first loss against one card's forward;
               command-r-plus-104b at 4 layers with SP on and off, and
               served whole on (1, 4) (the vocab-parallel argmax's ids
               against the gathered argmax's; the decode step captured as a
               CUDA graph on every rank, NCCL's all-reduces in it, and
               eager: the ids equal both ways on every rank, both tok/s, and
               one replay under the profiler with its NCCL kernels' time);
               qwen3-moe (2, 2) 1 layer with
               SP and under `moe-ep-data` against phase 8's losses; decode
               through the dry run's sequence-sharded caches (the
               partial-softmax combine) against one card in f32 and beside
               phase 7's ids in bf16, with the bytes a step sends.  With two
               or three cards the mesh paths say that they did not run;
               with one card the phase says that it did not run.
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
 12. example twins - examples/torch_serve_decode.py for gemma3-4b,
               minicpm3-4b (its q/k head of 24 padded to 32 by the op) and
               rwkv6-3b (scaled down, f32), each run's launches against
               prefill + decode + the greedy check's full forward, the
               greedy agreement printed, and its ids equal to those of a
               run with --device cpu from the same weights;
               examples/torch_train_lm.py at its 300 steps (B1 2, B2 1, B3 1
               a step a layer; its own gate), its first 3 losses within 2e-4
               of a --device cpu run's from the same weights;
               examples/torch_schedule_explorer.py with ocs-sim on the card
               (B6 launched, each call held bit for bit to the plain version
               on its own inputs, the largest timed) and on the CPU, its
               lines equal.  Phases 3 and 4 take the twins' shapes (f32).
 13. dry run - six cells of `python -m repro_torch.launch.dryrun` (one
               a mode, a MoE variant, the sequence-parallel train step and
               decode over sequence-sharded caches among them) in process on
               a fake world of 256 or 512 ranks; `torch.cuda.memory_allocated()`
               the same before and after.
Phase 5 also holds arctic-480b (1 layer, 32 of 128 experts, f32) card
against CPU, its routing decisions compared (a decision may differ only at
a near-tie under MODEL_TOL); phase 7 serves it at 2 of 35 layers (B1 2 a
prefill at GQA 7:1, D = 128), its peak beside the weights' reckoning;
phases 3 and 4 take its B1 shape.  Each phase prints its seconds.
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
import threading
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
from repro_torch.launch.serve import (CapturedDecode, Request, decode_loop,  # noqa: E402
                                      serve_requests)  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, prefill  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import tensor_parallel as tp_mod  # noqa: E402
from repro_torch.models.model import greedy, loss_fn  # noqa: E402
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
# qwen3-moe-235b-a22b trained (phase 8): GQA 16:1 at D = 128, 8 x 512
QWEN_TRAIN_CASE = (8, 64, 4, 512, 512, 128, True, None)
# the multi-card paths of phase 9, a rank's rows and heads under tensor
# parallelism over 'model' (the rows over 'data', the heads over 'model'):
# qwen3-moe on (2, 2), 4 rows, 32 of 64 query heads on 2 of 4 KV heads;
# recurrentgemma-9b on (2, 2), 8 of 16 heads on the one (replicated) KV
# head; stablelm-3b's pipeline microbatches (2 rows, whole) and its elastic
# restart resumed on (2, 2) (16 of 32 heads); command-r-plus-104b served on
# (1, 4) (24 of 96 heads on 2 of 8) and trained on (2, 2) and on (1, 4)
QWEN_RANK_CASE = (4, 32, 2, 512, 512, 128, True, None)
GRIFFIN_RANK_CASE = (4, 8, 1, 512, 512, 256, True, 2048)
STABLELM_RANK_CASE = (2, 32, 32, 512, 512, 80, True, None)
STABLELM_TP_CASE = (4, 16, 16, 512, 512, 80, True, None)
COMMAND_R_TP_CASE = (4, 24, 2, 512, 512, 128, True, None)
COMMAND_R_TRAIN_22 = (4, 48, 4, 512, 512, 128, True, None)
COMMAND_R_TRAIN_14 = (8, 24, 2, 512, 512, 128, True, None)
RANK_CASES = (QWEN_RANK_CASE, GRIFFIN_RANK_CASE, STABLELM_RANK_CASE, STABLELM_TP_CASE,
              COMMAND_R_TP_CASE, COMMAND_R_TRAIN_22, COMMAND_R_TRAIN_14)
# the tensor-parallel parity paths of phase 9 (f32): command-r-plus-104b's 2
# layers serving 4 prompts of 256 on (1, 4); stablelm-3b's 2 layers at 2 x
# 128 on (2, 2) (1 row, 16 heads a rank) and on (1, 4) (2 rows, 8 heads)
TP_SERVE_F32_CASE = (4, 24, 2, 256, 256, 128, True, None)
TP_TRAIN_F32_22 = (1, 16, 16, 128, 128, 80, True, None)
TP_TRAIN_F32_14 = (2, 8, 8, 128, 128, 80, True, None)
TP_F32_FWD_CASES = (TP_SERVE_F32_CASE, TP_TRAIN_F32_22, TP_TRAIN_F32_14)
NEW_CASES = (WHISPER_ENC_CASE, WHISPER_CROSS_CASE, WHISPER_CROSS_DECODE, WHISPER_SELF_CASE,
             MLA_CASE, INTERNVL_CASE)
# minicpm3-4b trained at 8 x 512 (phase 8): MLA's 40 heads, q/k of 96, V of 64
MLA_TRAIN_CASE = (8, 40, 40, 512, 512, 96, True, None, 64)
# gemma3-4b trained at 2 x 2048 (phase 8): 8 query heads of 256 on 4 K/V heads,
# its 29 local layers masked by their 1024-token window, its 5 global ones causal
GEMMA_TRAIN_LOCAL = (2, 8, 4, 2048, 2048, 256, True, 1024)
GEMMA_TRAIN_GLOBAL = (2, 8, 4, 2048, 2048, 256, True, None)
# gemma3-4b served (phase 7): 4 prompts of 1536, whose prefill outruns the
# window, and 4 of 1000, whose decode crosses the local ring's wrap
GEMMA_SERVE_LOCAL = (4, 8, 4, 1536, 1536, 256, True, 1024)
GEMMA_SERVE_GLOBAL = (4, 8, 4, 1536, 1536, 256, True, None)
GEMMA_WRAP_CASE = (4, 8, 4, 1000, 1000, 256, True, 1024)
# command-r-plus-104b served (phase 7): 96 query heads of 128 on 8 (GQA 12:1)
COMMAND_R_CASE = (4, 96, 8, 512, 512, 128, True, None)
# arctic-480b served (phase 7): 56 query heads of 128 on 8 (GQA 7:1)
ARCTIC_CASE = (4, 56, 8, 512, 512, 128, True, None)
# the serve twin's scaled-down minicpm3-4b (examples/torch_serve_decode.py):
# 4 heads of q/k 16 + 8 = 24, which the op pads to 32, and V of 16
TWIN_MLA_CASE = (4, 4, 4, 32, 32, 24, True, None, 16)
# the twins' other B1 shapes (examples/torch_*.py, the scaled-down configs,
# f32): serve_decode's gemma3-4b prefill (4 prompts of 32, 4 heads of 32, its
# local layers' window of 32 and the global layer), its greedy check's full
# forward over 32 + 16 tokens (gemma3-4b's and minicpm3-4b's), and
# train_lm's stablelm-3b at 16 x 64 (4 heads of 32)
TWIN_GEMMA_LOCAL = (4, 4, 4, 32, 32, 32, True, 32)
TWIN_GEMMA_GLOBAL = (4, 4, 4, 32, 32, 32, True, None)
TWIN_GEMMA_FULL_LOCAL = (4, 4, 4, 48, 48, 32, True, 32)
TWIN_GEMMA_FULL_GLOBAL = (4, 4, 4, 48, 48, 32, True, None)
TWIN_MLA_FULL = (4, 4, 4, 48, 48, 24, True, None, 16)
TWIN_TRAIN_FWD = (16, 4, 4, 64, 64, 32, True, None)
TWIN_FWD_CASES = (TWIN_MLA_CASE, TWIN_MLA_FULL, TWIN_GEMMA_LOCAL, TWIN_GEMMA_GLOBAL,
                  TWIN_GEMMA_FULL_LOCAL, TWIN_GEMMA_FULL_GLOBAL, TWIN_TRAIN_FWD)
# the shapes whose paths run B1 in f32: the twins' and the parity paths'
F32_FWD_CASES = TWIN_FWD_CASES + TP_F32_FWD_CASES
SLICE15_CASES = (MLA_TRAIN_CASE, GEMMA_TRAIN_LOCAL, GEMMA_TRAIN_GLOBAL, GEMMA_SERVE_LOCAL,
                 GEMMA_SERVE_GLOBAL, GEMMA_WRAP_CASE, COMMAND_R_CASE, ARCTIC_CASE)
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
QWEN_BWD_CASE = (8, 64, 512, 512, 128, True, None)          # GQA expanded by the op
QWEN_RANK_BWD = (4, 32, 512, 512, 128, True, None)       # a rank's under TP (phase 9)
GRIFFIN_RANK_BWD = (4, 8, 512, 512, 256, True, 2048)
STABLELM_TP_BWD = (4, 16, 512, 512, 80, True, None)
COMMAND_R_BWD_22 = (4, 48, 512, 512, 128, True, None)
COMMAND_R_BWD_14 = (8, 24, 512, 512, 128, True, None)
# minicpm3-4b's: the eighth field is the value head (64), which the op pads
# to 96, so V and dO are zero past it; gemma3-4b's at 2 x 2048, K/V expanded
MLA_BWD_CASE = (8, 40, 512, 512, 96, True, None, 64)
GEMMA_BWD_LOCAL = (2, 8, 2048, 2048, 256, True, 1024)
GEMMA_BWD_GLOBAL = (2, 8, 2048, 2048, 256, True, None)
# train_lm's twin: stablelm-3b scaled down (f32), 16 x 64, 4 heads of 32
TWIN_TRAIN_BWD = (16, 4, 64, 64, 32, True, None)
TRAIN_BWD_CASES = (TRAIN_CASE, GRIFFIN_BWD_CASE, QWEN_BWD_CASE, QWEN_RANK_BWD,
                   GRIFFIN_RANK_BWD, STABLELM_TP_BWD, MLA_BWD_CASE, GEMMA_BWD_LOCAL,
                   GEMMA_BWD_GLOBAL, COMMAND_R_BWD_22, COMMAND_R_BWD_14)
# the f32 training paths' B2 / B3 shapes: the train twin's, the TP parity's
TP_TRAIN_F32_BWD = ((1, 16, 128, 128, 80, True, None), (2, 8, 128, 128, 80, True, None))
F32_BWD_CASES = (TWIN_TRAIN_BWD, *TP_TRAIN_F32_BWD)
WIDE_BWD_CASE = (1, 8, 300, 300, 256, True, 100)
GQA_CASE = (1, 8, 2, 160, 160, 32, True, 64)      # through the op: b, hq, hkv, s, s, d, ...
GQA_SEEDS = range(5)
# ragged Sq and Sk: Sq < Sk causal, Sq > Sk bidirectional
BWD_RAGGED_CASES = [(1, 4, 72, 300, 80, True, None), (1, 2, 100, 72, 80, False, None),
                    (1, 4, 72, 300, 96, True, None, 64)]
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
DOTS_LOSS_RTOL = 1e-5    # remat dots against full, where not bit for bit
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
# serve_decode's twin, rwkv6-3b scaled down (f32, 8 heads of K = V = 16): its
# prefill of 4 x 32 and decode steps from the cache's state, and its greedy
# check's full forward over 32 + 16 tokens from none
TWIN_WKV_PREFILL = (4, 8, 32, 16, 16, True)
TWIN_WKV_STEP = (4, 8, 1, 16, 16, True)
TWIN_WKV_FULL = (4, 8, 48, 16, 16, False)
TWIN_WKV_CASES = (TWIN_WKV_STEP, TWIN_WKV_PREFILL, TWIN_WKV_FULL)
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
LRU_RANK = (4, 512, 2048, False)   # recurrentgemma-9b on (2, 2): 4 rows, 4096 / 2 channels
WKV_TRAIN = (8, 40, 512, 64, 64, False)
WKV_RANK = (8, 10, 512, 64, 64, False)   # rwkv6-3b on (1, 4): 8 rows, 40 / 4 heads
WKV_TRAIN_CASES = (WKV_TRAIN, WKV_RANK)
LRU_EXTREME = (2, 64, 48, True)   # a = e^-20: each step forgets almost all
# B4' and B5' against their plain versions: f32 as the CPU tests hold the
# plain backward to JAX's gradients (1e-5, 1e-4); bf16 2e-2 + 2e-2|want|
# (both sides round each gradient to bf16, and B4' reads h as the forward's
# bf16 y, one bf16 step from the plain version's f32 h)
LRU_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
WKV_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU training parity: arch, layers kept (recurrentgemma-9b's two
# RG-LRU layers; full width otherwise)
TRAIN_PARITY_ARCHS = (("stablelm-3b", 2), ("rwkv6-3b", 2), ("recurrentgemma-9b", 2),
                      ("minicpm3-4b", 2))
# trained on the main path: arch, layers kept (None: all).  recurrentgemma-9b
# whole is ~9.4 G parameters, ~113 GB of bf16 weights and gradients and f32
# moments: one pattern period (rglru, rglru, local) at full width fits.
# minicpm3-4b (4.26 G) and gemma3-4b (3.88 G) train whole
TRAIN_ARCHS = (("stablelm-3b", None), ("rwkv6-3b", None), ("recurrentgemma-9b", 3),
               ("minicpm3-4b", None), ("gemma3-4b", None))
# (batch, sequence) of a trained arch where it is not TRAIN_CASE's 8 x 512:
# gemma3-4b's 4096 tokens a step as 2 x 2048, so that every local layer's
# window (1024) masks
TRAIN_SHAPE = {"gemma3-4b": (2, 2048)}
# trained again under remat_policy "dots" right after their "full" run
DOTS_ARCHS = ("stablelm-3b", "rwkv6-3b")
# card vs CPU model parity: arch, layers kept (full width otherwise)
PARITY_ARCHS = (("stablelm-3b", 4), ("recurrentgemma-9b", 3), ("rwkv6-3b", 2),
                ("qwen3-moe-235b-a22b", 1), ("minicpm3-4b", 2), ("whisper-base", 6),
                ("internvl2-26b", 1), ("gemma3-4b", 6), ("arctic-480b", 1))
# other cuts of the parity check, so that the CPU side stays in seconds:
# internvl2's 1024 patches to 64 (whisper keeps its 6 encoder layers and 1500
# frames); gemma3's window to 100 (5 local layers and the global one), so that
# the 128-token prefill masks by it and wraps the local ring, and the decode
# steps read the wrapped ring
# arctic-480b's layer is 54.4 GB in f32, and its CPU copy as much again on the
# host: 32 of its 128 experts (d_model, the expert and dense-residual widths,
# top-2 and the capacity factor kept)
PARITY_CUTS = {"internvl2-26b": {"frontend_seq": 64}, "gemma3-4b": {"window": 100},
               "arctic-480b": {"moe": dataclasses.replace(configs.get("arctic-480b").moe,
                                                         num_experts=32)}}
SERVE_ARCHS = ("stablelm-3b", "recurrentgemma-9b", "rwkv6-3b", "qwen3-moe-235b-a22b",
               "minicpm3-4b", "whisper-base", "internvl2-26b", "gemma3-4b",
               "command-r-plus-104b", "arctic-480b")
# served prompt lengths (tokens; 512 unless named): whisper's decoder context
# is 448 tokens, so 64 + 32 new; internvl2 prepends its 1024 patches to 512
SERVE_PROMPT = {"whisper-base": 64}
# served runs of (prompt, new tokens) where not (SERVE_PROMPT, 32): gemma3-4b
# past its 1024-token window, in prefill (1536) and across the ring's wrap in
# decode (1000 + 64)
SERVE_LENGTHS = {"gemma3-4b": ((1536, 32), (1000, 64))}
# served depth where the whole model does not fit one card: qwen3-moe's 94
# layers are ~470 GB in bf16; 8 layers and the untied embed and unembed are
# ~42.3 GB.  command-r-plus-104b's 64 are ~208 GB; 12 layers and its untied
# embed and unembed are 25.17 G parameters, ~50.3 GB.  The other served
# models keep their full configs.
# arctic-480b's layer is 13.61 G parameters (128 experts of 3 x 7168 x 4864,
# the dense residual, attention): 2 layers and the untied embed and unembed
# are 27.68 G, ~55.4 GB (51.6 GiB)
SERVE_DEPTH = {"qwen3-moe-235b-a22b": 8, "command-r-plus-104b": 12, "arctic-480b": 2}
# phase 7 serves each model with its decode step captured as a CUDA graph
# (`serve_requests`' default on the card) and again eagerly (graph=False),
# the ids equal; these archs' runs alternate GRAPH_REPEATS times each way for
# the decode tok/s (host-clock rates spread between runs)
GRAPH_REPEAT_ARCHS = ("stablelm-3b", "rwkv6-3b", "recurrentgemma-9b", "gemma3-4b",
                      "qwen3-moe-235b-a22b")
GRAPH_REPEATS = 3
# the kernels a decode-path wrapper launches, by name, one a call: its decode
# design first (B1's tensor-core variant, whisper's cross attention; B4's and
# B5's step kernels), then its others (B5's two-pass design counted by its
# first pass); a decode's launches under the profiler are these kernels' events
WRAPPER_KERNELS = {"flash_attention_fwd": ("flash_fwd_tc_kernel", "flash_fwd_f32_kernel"),
                   "rg_lru_fwd": ("rg_lru_step_kernel", "rg_lru_scan_kernel"),
                   "wkv6_fwd": ("wkv6_step_kernel", "wkv6_state_kernel", "wkv6_f32_kernel")}
REPLAY_TIMED = 10   # replays timed on the host clock after the profiled one
RECKONING_GIB = {"arctic-480b": 27.68e9 * 2 / 2**30}
# the SDPA backends tried for the attention yardstick (torch.nn.attention.SDPBackend)
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


_PHASE = {"name": None, "t0": 0.0, "start": time.perf_counter()}


def phase(name: str | None):
    """Start phase `name` (None: the end), printing the seconds of the last."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"== {_PHASE['name']}: {now - _PHASE['t0']:.1f} s "
              f"({now - _PHASE['start']:.1f} s since the start)", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
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
    the query head, and a query head between the kernel's head dims, are
    zero-padded as `ops.flash_attention` pads them, and the output sliced
    back; the op's own output must equal it bit for bit."""
    d, dv = q.shape[-1], v.shape[-1]
    head = flash_ops.padded_head(d)
    if dv == d == head:
        return flash_kernel.flash_attention_fwd_lse(q, k, v, scale=d ** -0.5,
                                                    causal=causal, window=window)
    q_p, k_p, v_p = (torch.nn.functional.pad(t, (0, head - t.shape[-1])) for t in (q, k, v))
    out, lse = flash_kernel.flash_attention_fwd_lse(q_p, k_p, v_p, scale=d ** -0.5,
                                                    causal=causal, window=window)
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
                                GRIFFIN_TRAIN_CASE, QWEN_CASE, QWEN_TRAIN_CASE, *RANK_CASES,
                                *NEW_CASES, *SLICE15_CASES, *RAGGED_CASES, *F32_FWD_CASES)
              for dt in (torch.bfloat16, torch.float32)]
    return cases


def check_kernels() -> dict:
    """Kernel vs plain version on the card; returns the errors in the dtype
    each case's path runs (bf16; f32 for the twins' cases), keyed by the
    case."""
    errs = {}
    for case, dtype in flash_check_cases():
        err, verdicts, line = check_flash(case, dtype)
        print(line)
        if not verdicts["variant"]:
            raise AssertionError(f"flash {case} {dtype}: not the variant of its dtype")
        if not all(verdicts.values()):
            raise AssertionError(f"kernel disagrees with its plain version: {line}")
        if dtype == (torch.float32 if case in F32_FWD_CASES else torch.bfloat16):
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
    if not ok:  # no fused kernel (f32 with GQA): SDPA's composite of matmuls
        with sdpa_kernel(SDPBackend.MATH):
            fn()
        torch.cuda.synchronize()
        print("  SDPA backends: no fused kernel runs here; MATH (its composite) does")
        ok.append("MATH")
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


def sdpa_mask(sq: int, sk: int, causal: bool, window: int | None):
    """None where SDPA's is_causal computes the mask (no window, or one that
    covers every causal key), else the boolean (sq, sk) mask on the card: a
    window shorter than the keys, which SDPA takes only as a mask."""
    if window is None or window >= sk:
        return None
    return flash_ref.attention_mask(sq, sk, causal, window).to("cuda")


def time_flash(case, dtype=torch.bfloat16) -> dict:
    """B1 at `case` in `dtype` (bf16: the main paths'; f32: the twins'):
    kernel, plain, library (each SDPA backend), bound.
    A case with a narrower value head (MLA), or a query head between the
    kernel's head dims, times the op's call, padding and slice included, as
    the path makes it (`ms`, `device_ms`), and the kernel alone on q, k and
    v padded beforehand as the op pads them (`kernel_padded_device_ms`); its
    bound and library time are those of the unpadded function."""
    b, hq, hkv, sq, sk, d, causal, window = case[:8]
    q, k, v = (t.to(dtype) for t in flash_inputs(case))
    dv = v.shape[-1]
    scale = d ** -0.5
    mask = sdpa_mask(sq, sk, causal, window)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
        enable_gqa=hq != hkv)
    head = flash_ops.padded_head(d)
    if dv == d == head:
        call = lambda: flash_kernel.flash_attention_fwd_lse(  # noqa: E731
            q, k, v, scale=scale, causal=causal, window=window)
    else:
        call = lambda: flash_ops.flash_attention(q, k, v, causal, window, scale)  # noqa: E731
    fns = {"ms": call, "device_ms": call,
           "plain_ms": lambda: flash_ref.attention_fwd_lse(
               q, k, v, scale=scale, causal=causal, window=window)}
    padded_in = [torch.nn.functional.pad(t, (0, head - t.shape[-1])) for t in (q, k, v)]
    if dv < head:
        fns["kernel_padded_device_ms"] = lambda: flash_kernel.flash_attention_fwd_lse(
            *padded_in, scale=scale, causal=causal, window=window)
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
    times["bound_ms"], times["bound_by"] = bound(moved, flops, PEAK_FLOP_S[dtype])
    padded_bytes = (sum(t.numel() for t in padded_in) + b * hq * sq * head) * elem \
        + b * hq * sq * 4
    padded = (f" kernel_padded_device_ms {times['kernel_padded_device_ms']:.4f} (q, k, v "
              f"padded to {head} beforehand: {padded_bytes} bytes)" if dv < head else "")
    print(f"flash timing {case} {str(dtype)[6:]}: kernel_ms {times['ms']:.4f} "
          f"device_ms {times['device_ms']:.4f}{padded} plain_ms {times['plain_ms']:.4f} "
          f"{library_text(times)} bound_ms {times['bound_ms']:.4f} "
          f"(by {times['bound_by']}: {moved} bytes, {flops} FLOP; H100 SXM peaks "
          f"{H100_HBM_BYTES_S:.3g} B/s, {PEAK_FLOP_S[dtype]:.3g} FLOP/s)")
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
    # a decision may differ only at a near-tie of the router's top-k
    if any(g >= MODEL_TOL for g in gaps):
        raise AssertionError(f"{arch}: a routing decision differs at a top-k gap of "
                             f"{max(gaps):.3e} (near-tie bound {MODEL_TOL})")


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
    parts = [f"{v.num_experts} of {configs.get(arch).moe.num_experts} experts" if k == "moe"
             else f"{k} {v}" for k, v in PARITY_CUTS.get(arch, {}).items()]
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
    per_pass = {"flash_attention_fwd": sum(k in ATTENTION_KINDS for k in kinds)
                + cross + (cfg.num_encoder_layers if cfg.enc_dec else 0),
                "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
                "rg_lru_fwd": kinds.count("rglru"), "wkv6_fwd": kinds.count("rwkv6"),
                "rg_lru_bwd": 0, "wkv6_bwd": 0}
    per_step = dict(per_pass, flash_attention_fwd=cross)
    decode = {k: v * (new_tokens - 1) for k, v in per_step.items()}
    return per_pass, decode


@torch.inference_mode()
def serve_entry_points(cfg, model, prompts, extra: dict, new_tokens: int, max_seq: int,
                       progress, graph: bool = True) -> dict:
    """`serve_requests` through the model entry point `prefill`, for a model
    that needs inputs beside the tokens (whisper's frames, internvl2's
    patches), which the reference's serving driver does not take: prefill
    timed to the first greedy ids on the host, with the driver's progress
    line, then the driver's own decode (`decode_loop`, with `graph` as
    `serve_requests` passes it) of every request to `new_tokens`.  Returns
    {request: ids}."""
    batch = prompts.shape[0]
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, model, {"tokens": prompts.cuda(), **extra}, max_seq,
                             logits_whole=False)
    tok = greedy(cfg, model, logits)[:, None]
    tok.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    progress(f"prefill: {batch} x {prompts.shape[1]} tokens in {dt:.3f}s "
             f"({prompts.numel() / dt:.1f} tok/s)")
    out = decode_loop(cfg, model, caches, tok, [new_tokens] * batch, graph, progress)
    return {i: out[i].tolist() for i in range(batch)}


def kernel_events(prof) -> dict:
    """{kernel name: events} of the CUDA kernels a stopped torch.profiler run
    saw (a CUDA graph's replays included: each replayed kernel is an event),
    read from the profiler's raw events: building its Python event list
    takes seconds for a decode's ~100,000 kernels."""
    from collections import Counter

    from torch.autograd import DeviceType

    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)


def wrapper_launches(events: dict) -> tuple[dict, dict]:
    """The decode-path wrappers' launches and designs measured from kernel
    events (`kernel_events`): each call launches one of its WRAPPER_KERNELS
    once.  Returns ({wrapper: launches}, {wrapper: {design counter: n}})."""
    def n(name):
        return sum(c for k, c in events.items() if name in k)

    launches = {w: sum(n(k) for k in names) for w, names in WRAPPER_KERNELS.items()}
    designs = {"flash_attention_fwd": {"launches_tc": n("flash_fwd_tc_kernel")},
               "rg_lru_fwd": {"launches_step": n("rg_lru_step_kernel")},
               "wkv6_fwd": {"launches_chunked": n("wkv6_state_kernel"),
                            "launches_step": n("wkv6_step_kernel")}}
    return launches, designs


def replays_of(line: str) -> int | None:
    """The replays of a served run's decode line (None for an eager run)."""
    got = re.search(r"warm-up and capture [0-9.]+s, ([0-9]+) replays", line)
    return None if got is None else int(got.group(1))


def served_run(cfg, model, prompts, extra: dict, new_tokens: int, max_seq: int,
               graph: bool, label: str, counted: bool = False) -> dict:
    """One served run of `cfg`'s model, through `serve_requests` (or the
    entry points where it needs frames or patches), with its decode step
    captured (`graph`) or eager: its ids, the kernel launches and designs of
    its prefill and decode, the prefill seconds, the decode tok/s, the
    replays and the peak memory.  The launches are the wrappers' counters,
    which see every eager launch but, of a captured decode, only the warm-up
    step and the capture (which launches nothing), not the replays.  With
    `counted` the decode runs under torch.profiler and its launches and
    designs are the decode-path kernels' events (`wrapper_launches`), every
    replay's included; every B1 launch there must be the tensor-core
    variant's."""
    from torch.profiler import ProfilerActivity, profile

    batch, prompt_len = prompts.shape
    reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=new_tokens)
            for i in range(batch)]
    messages, at_prefill, designs_at_prefill = [], {}, {}
    prof = profile(activities=[ProfilerActivity.CUDA]) if counted else None

    def progress(msg):
        if not messages:  # prefill is done (and synchronised): its launches so far
            at_prefill.update(read_launches())
            designs_at_prefill.update(read_designs())
            if prof is not None:
                prof.start()
        elif prof is not None and len(messages) == 1:  # decode is done, its ids read
            prof.stop()
        messages.append(msg)
        print(f"{label}: {msg}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if extra:
        out = serve_entry_points(cfg, model, prompts, extra, new_tokens, max_seq, progress,
                                 graph)
    else:
        out = serve_requests(cfg, model, reqs, max_seq=max_seq, progress=progress,
                             device="cuda", graph=graph)
    replays = replays_of(messages[1])
    if graph != (replays is not None):
        raise AssertionError(f"{label}: graph={graph}, decode {messages[1]!r}")
    total, designs_total = read_launches(), read_designs()
    check_tensor_core_launches(label)
    decode = {k: total[k] - at_prefill[k] for k in total}
    designs = {name: {k: designs_total[name][k] - designs_at_prefill[name][k] for k in keys}
               for name, keys in DESIGN_COUNTERS.items()}
    if counted:
        t0 = time.perf_counter()
        measured, measured_designs = wrapper_launches(kernel_events(prof))
        read_s = time.perf_counter() - t0
        tc = measured_designs.pop("flash_attention_fwd")["launches_tc"]
        if tc != measured["flash_attention_fwd"]:
            raise AssertionError(f"{label}: {measured['flash_attention_fwd'] - tc} B1 decode "
                                 f"launches missed the tensor-core variant")
        print(f"{label}: decode launches counted as kernel events under the profiler (the "
              f"warm-up step and {replays} replays) {measured}; the counters saw {decode} (the "
              f"warm-up step and the capture); the events read in {read_s:.3f}s", flush=True)
        decode.update(measured)
        for name, keys in measured_designs.items():
            designs[name].update(keys)
    return {"ids": out, "peak": torch.cuda.max_memory_allocated(), "replays": replays,
            "launches": {"prefill": at_prefill, "decode": decode},
            "designs": {"prefill": designs_at_prefill, "decode": designs},
            "prefill_s": float(re.search(r"prefill: .* in ([0-9.]+)s", messages[0]).group(1)),
            "decode_tps": float(re.search(r"\(([0-9.]+) tok/s\)", messages[1]).group(1)),
            "replay_tps": replay_rate(messages[1], prompts.shape[0])}


def replay_rate(line: str, batch: int) -> float | None:
    """The tok/s of a served run's replays alone, from its decode line: the
    loop's seconds less the warm-up and capture's, over the replays' tokens
    (None for an eager run)."""
    got = re.search(r", ([0-9.]+)s \(.*warm-up and capture ([0-9.]+)s, ([0-9]+) replays",
                    line)
    if got is None:
        return None
    loop_s, capture_s, replays = float(got.group(1)), float(got.group(2)), int(got.group(3))
    return round(batch * replays / (loop_s - capture_s), 1)


def serve_path(arch: str, prompt_len: int, new_tokens: int,
               repeats: int = 1) -> tuple[dict, dict]:
    """`arch` at its full published config (its depth cut to SERVE_DEPTH
    where that names it) answers 4 requests of `prompt_len`-token prompts
    (whisper: after encoding 1500 frames; internvl2: after its 1024 patches)
    and `new_tokens` new tokens each, through `serve_requests`, or through
    the model entry points where the model needs frames or patches: with
    the decode step captured as a CUDA graph and again eagerly: first one
    captured run whose decode launches are counted under the profiler, then
    timed runs in turns `repeats` times each way, every run's ids equal and
    its launches checked.  Then the first replayed step's logits against the
    eager step's at the same position, and one eager step and one replay
    under the profiler.  Returns the launch counts of the counted run, split
    into prefill and decode, and the ids served, {request: ids}."""
    cfg = configs.get(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
    batch = 4
    max_seq = cfg.frontend_seq + prompt_len + new_tokens + 1
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    rng = torch.Generator().manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=rng,
                            dtype=torch.int32)
    extra = {k: t.cuda().to(torch.bfloat16) for k, t in
             extra_inputs(cfg, batch, torch.Generator().manual_seed(SEED + 3)).items()}
    want_prefill, want_decode = expected_serve_launches(cfg, new_tokens)
    # every prefill call of B4 in the ring, of B5 (bf16) in the two-pass
    # design; every decode call (T = 1) of both in the step kernel
    want_designs = {
        "prefill": {"rg_lru_fwd": {"launches_step": 0},
                    "wkv6_fwd": {"launches_chunked": want_prefill["wkv6_fwd"],
                                 "launches_step": 0},
                    "wkv6_bwd": {"launches_chunked": 0, "launches_entry": 0}},
        "decode": {"rg_lru_fwd": {"launches_step": want_decode["rg_lru_fwd"]},
                   "wkv6_fwd": {"launches_chunked": 0,
                                "launches_step": want_decode["wkv6_fwd"]},
                   "wkv6_bwd": {"launches_chunked": 0, "launches_entry": 0}}}
    per_step = {k: n // (new_tokens - 1) for k, n in want_decode.items()}
    # a timed captured run's counters see its warm-up step and its capture
    want_graph_decode = {k: 2 * n for k, n in per_step.items()}
    counted, runs = None, []
    ways = [("graph counted", True)] + [(f"{'graph' if graph else 'eager'} run {k + 1}", graph)
                                        for k in range(repeats) for graph in (True, False)]
    for name, graph in ways:
        label = f"serve {arch} {name}"
        run = served_run(cfg, model, prompts, extra, new_tokens, max_seq, graph, label,
                         counted=counted is None)
        want = want_graph_decode if graph and counted is not None else want_decode
        if run["launches"]["prefill"] != want_prefill or run["launches"]["decode"] != want:
            raise AssertionError(f"{label}: launches {run['launches']}, expected prefill "
                                 f"{want_prefill}, decode {want}")
        if run["designs"]["prefill"] != want_designs["prefill"] or (
                want is want_decode and run["designs"] != want_designs):
            raise AssertionError(f"{label}: B4 / B5 designs {run['designs']}, expected "
                                 f"{want_designs}")
        if counted is not None and run["ids"] != counted["ids"]:
            raise AssertionError(f"{label}: ids differ from the counted captured run's")
        if counted is None:
            counted = run
        else:
            runs.append(run)
    out = counted["ids"]
    launches, peak = counted["launches"], runs[0]["peak"]
    print(f"serve {arch}: B4 / B5 designs {counted['designs']}")
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
    replay_logits_against_eager(arch, cfg, model, prompts, extra, gen, max_seq, per_step)
    if cfg.ffn == "moe":
        moe_breakdown(cfg, model)

    inputs = ", ".join(f"{k} {tuple(t.shape)}" for k, t in extra.items())
    ways = {"graph": runs[0::2], "eager": runs[1::2]}
    prefill_s, decode_tps = runs[0]["prefill_s"], runs[0]["decode_tps"]
    print(f"serve {arch} full config ({cfg.num_layers} layers"
          + (f" + {cfg.num_encoder_layers} encoder layers" if cfg.enc_dec else "") + "), "
          f"{batch} x ({prompt_len} + {new_tokens})" + (f" beside {inputs}" if extra else "")
          + f": prefill {prefill_s:.3f} s = {batch * prompt_len / prefill_s:.1f} tok/s"
          + (f" ({batch * (cfg.frontend_seq + prompt_len) / prefill_s:.1f} positions/s)"
             if cfg.frontend_seq else "") + ", "
          f"decode {decode_tps:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes)"
          + (f" beside the weights' reckoning {RECKONING_GIB[arch]:.1f} GiB"
             if arch in RECKONING_GIB else "")
          + f", greedy agreement with full forward {agree:.1f}%, "
          f"launches prefill {launches['prefill']}, decode {launches['decode']}")
    print(f"serve {arch} decode both ways, {repeats} run(s) each in turns, ids equal: "
          + "; ".join(f"{way} decode tok/s {[r['decode_tps'] for r in rs]}"
                      + (f" (the replays alone {[r['replay_tps'] for r in rs]})"
                         if way == "graph" else "") + ", prefill s "
                      f"{[r['prefill_s'] for r in rs]}, peak memory GiB "
                      f"{[round(r['peak'] / 2**30, 3) for r in rs]} "
                      f"({[r['peak'] for r in rs]} bytes)" for way, rs in ways.items()))
    return launches, out


@torch.inference_mode()
def replay_logits_against_eager(arch: str, cfg, model, prompts, extra: dict, gen,
                                max_seq: int, per_step: dict) -> None:
    """From a fresh prefill, two eager decode steps (the served ids' first
    token in) and the second's logits; from another, a CapturedDecode (its
    eager warm-up step, then the capture) replayed once: its logits at the
    same position, held bit for bit against the eager ones (else the largest
    difference printed; the ids are held by the served runs).  Then one more
    eager step and one more replay under the profiler; the replay's
    hand-written kernels, counted by name, must be one step's launches
    (`per_step`, {wrapper: launches}), B1's in the tensor-core variant."""
    batch = {"tokens": prompts.cuda(), **extra}
    first = gen[:, :1].cuda()
    _, caches = prefill(cfg, model, batch, max_seq)
    logits, caches = decode_step(cfg, model, first, caches)
    eager, caches = decode_step(cfg, model, torch.argmax(logits, -1)[:, None], caches)
    eager = eager.clone()
    step = torch.argmax(eager, -1)[:, None]
    decode_step(cfg, model, step, caches)
    prof = profiled(lambda: decode_step(cfg, model, step, caches))
    print(f"serve {arch} decode step (batch {batch['tokens'].shape[0]}) under the profiler: "
          f"{profile_text(prof)}")
    del caches, logits
    _, caches = prefill(cfg, model, batch, max_seq)
    cap = CapturedDecode(cfg, model, caches, first)
    cap.step()
    same = torch.equal(cap.logits, eager)
    diff = (cap.logits - eager).abs().max().item()
    ids_same = torch.equal(cap.token, step)
    print(f"serve {arch}: the first replayed step's logits {tuple(eager.shape)} against the "
          f"eager step's at the same position: bit for bit {same}"
          + ("" if same else f", max|diff| {diff:.6g}") + f"; ids equal {ids_same}")
    if not ids_same:
        raise AssertionError(f"{arch}: the replayed step's ids differ from the eager step's")
    prof = profiled(cap.step, by_kernel=True)
    kernels = prof.pop("kernels")
    # the profiler's own cost inflates a replay's wall: the host clock over
    # REPLAY_TIMED replays, each ending in the host's read of its ids
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPLAY_TIMED):
        cap.step().cpu()
    wall = (time.perf_counter() - t0) / REPLAY_TIMED * 1e3
    ours = sorted((k, n) for k, n in kernels.items()
                  if any(w in k for names in WRAPPER_KERNELS.values() for w in names))
    print(f"serve {arch} decode step replayed as a CUDA graph under the profiler: "
          f"{profile_text(prof)}; its hand-written kernels (name, events) {ours}; "
          f"without the profiler {wall:.3f} ms a replay and its ids' read (host clock, "
          f"{REPLAY_TIMED} replays), idle {(1 - prof['device_ms'] / wall) * 100:.1f} % of it")
    replayed, designs = wrapper_launches(kernels)
    want = {w: per_step[w] for w in WRAPPER_KERNELS}
    if replayed != want or designs["flash_attention_fwd"]["launches_tc"] != want[
            "flash_attention_fwd"]:
        raise AssertionError(f"{arch}: the profiled replay launched {replayed} (designs "
                             f"{designs}), one step launches {want}; kernels seen "
                             f"{sorted(kernels)[:40]}")
    del cap, caches


def profiled(fn, top: int = 8, by_kernel: bool = False) -> dict:
    """One call of `fn` (warm) under torch.profiler, CPU and CUDA: its wall
    ms (host clock, ending in a synchronize, the profiler's own cost
    included), the device ms (the kernels' device times summed: one stream),
    the device's idle share of the wall time, the host's reads of device
    values (`aten::_local_scalar_dense`, each a sync), the `top` ops by
    their kernels' device ms (`by_kernel`: the kernels themselves, as a
    CUDA graph's replay launches them), the NCCL kernels' device ms and
    every kernel's events by name."""
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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if by_kernel:  # a graph replay: no op launched its kernels, so the kernels by name
        ops = sorted(((e.key, round(e.self_device_time_total / 1e3, 4), e.count)
                      for e in kernels), key=lambda op: -op[1])
    nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower()) / 1e3
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1 - device / wall if device else None,
            "host_reads": reads, "top_ops": ops[:top], "nccl_ms": nccl,
            "kernels": {e.key: e.count for e in kernels}}


def profile_text(prof: dict) -> str:
    if not prof["device_ms"]:
        return (f"wall {prof['wall_ms']:.3f} ms, device time not measured (the profiler "
                f"saw no kernel)")
    return (f"wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, idle "
            f"{prof['idle_share'] * 100:.1f} %, host reads of device values "
            f"{prof['host_reads']}, top ops (name, device ms, calls) {prof['top_ops']}"
            + (f", NCCL kernels {prof['nccl_ms']:.4f} ms" if prof["nccl_ms"] else ""))


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
    """q, k, v, do (MHA) and the forward's o, lse, dvec on the card.  Where
    the case has an eighth field (MLA's value head, narrower than D), V and
    dO are zero past it, as `ops.flash_attention` pads them, and so is O."""
    b, h, sq, sk, d, causal, window = case[:7]
    gen = case_generator("bwd", case)
    shapes = ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d))
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in shapes)
    if len(case) > 7:
        v[..., case[7]:] = 0
        do[..., case[7]:] = 0
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
    the training shapes in the dtype their paths run (bf16; f32 for the
    train twin's), keyed by (kernel, case)."""
    errs = {}
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16)
             for c in BWD_CASES + [*TRAIN_BWD_CASES, WIDE_BWD_CASE, *BWD_RAGGED_CASES,
                                   *F32_BWD_CASES]]
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
        if (case in TRAIN_BWD_CASES and dtype == torch.bfloat16) \
                or (case in F32_BWD_CASES and dtype == torch.float32):
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
    # the same at the training shapes (MLA's at D = 96 in both dtypes), kernel
    # by kernel
    for case, dtype in ((TRAIN_CASE, torch.bfloat16), (MLA_BWD_CASE, torch.bfloat16),
                        (MLA_BWD_CASE, torch.float32)):
        d, causal, window = case[4], case[5], case[6]
        q, k, v, do, _, lse, dvec = bwd_inputs(case, dtype)
        kw = {"scale": d ** -0.5, "causal": causal, "window": window}
        for fn in (flash_bwd.flash_attention_bwd_dkv, flash_bwd.flash_attention_bwd_dq):
            first, second = (fn(q, k, v, do, lse, dvec, **kw) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, second, strict=True)):
                raise AssertionError(f"{fn.__name__} {case} {dtype} differs between two "
                                     f"runs on the card")
    print(f"flash op and bwd kernels: two runs on the card are bit-identical (bwd at "
          f"{TRAIN_CASE} bf16, {MLA_BWD_CASE} bf16 and f32)")
    return errs


def time_bwd(case, dtype=torch.bfloat16) -> dict:
    """B2 and B3 at a training shape in `dtype` (bf16: the main paths'; f32:
    the train twin's): kernel, plain, library, bound.
    SDPA takes a window shorter than the keys as a boolean mask.  An MLA case
    (an eighth field: the value head) times the kernels on V and dO padded as
    the op pads them; its bound and library time are the unpadded
    function's (V, dO and dV of 64)."""
    b, h, sq, sk, d, causal, window = case[:7]
    dv = case[7] if len(case) > 7 else d
    q, k, v, do, o, lse, dvec = bwd_inputs(case, dtype)
    kw = {"scale": d ** -0.5, "causal": causal, "window": window}
    # the library yardstick: the backward of PyTorch's fused attention on the
    # same inputs (dq, dk and dv together) under each SDPA backend that runs
    # here, timed only for comparison
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v[..., :dv].contiguous()))
    ldo = do[..., :dv].contiguous()
    mask = sdpa_mask(sq, sk, causal, window)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask, is_causal=causal and mask is None, scale=d ** -0.5)

    def library_fn(backend):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(getattr(SDPBackend, backend)):
            lout = sdpa()
        return lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True)

    library = {name: library_fn(name) for name in sdpa_backends(
        lambda: torch.autograd.grad(sdpa(), (lq, lk, lv), ldo))}
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
    # live (query, key) pairs: B2 QK^T, dO V^T, P^T dO, dS^T Q (8 D each,
    # 4 D + 4 Dv with a value head Dv), B3 QK^T, dO V^T, dS K (6 D, 4 D + 2 Dv)
    elem = q.element_size()
    live = int(flash_ref.attention_mask(sq, sk, causal, window).sum()) * b * h
    narrow = b * h * sk * dv  # V's and dV's elements, dO's b h sq dv
    reads = (q.numel() + k.numel() + narrow + b * h * sq * dv) * elem + 2 * lse.numel() * 4
    work = {"flash_attention_bwd_dkv": (reads + (k.numel() + narrow) * elem,
                                        (4 * d + 4 * dv) * live),
            "flash_attention_bwd_dq": (reads + q.numel() * elem, (4 * d + 2 * dv) * live)}
    times = {}
    for name in fns:
        moved, flops = work[name]
        bound_ms, by = bound(moved, flops, PEAK_FLOP_S[dtype])
        times[name] = {"ms": med[(name, "ms")], "device_ms": med[(name, "device_ms")],
                       "plain_ms": med[(name, "plain_ms")],
                       "bound_ms": bound_ms, "bound_by": by, **lib}
        t = times[name]
        print(f"{name} timing {case} {str(dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
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
    them in (f32 for the serve twin's)."""
    errs = {}
    dtypes = (torch.float32, torch.bfloat16)
    lru_cases = LRU_CASES + [LRU_DECODE, LRU_PREFILL, LRU_TRAIN, LRU_RANK, LRU_RAGGED] + LRU_ODD
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
        if case in (LRU_PREFILL, LRU_DECODE, LRU_TRAIN, LRU_RANK) \
                and dtype == PATH_DTYPE["rg_lru_fwd"]:
            errs[("rg_lru_fwd", case)] = max(ey, eh)
    for dtype in dtypes:
        args = lru_inputs(LRU_RAGGED, dtype)
        first, second = (lru_call(*args) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second, strict=True)):
            raise AssertionError(f"B4's ring differs between two runs on the card ({dtype})")
    print("rg_lru ring: two runs on the card are bit-identical (f32, bf16)")
    for case, dtype in [(c, dt) for c in WKV_CASES + [WKV_DECODE, WKV_PREFILL, WKV_RAGGED,
                                                      *TWIN_WKV_CASES]
                        for dt in dtypes] + [(c, PATH_DTYPE["wkv6_fwd"]) for c in WKV_TRAIN_CASES]:
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
        if (case in (WKV_PREFILL, WKV_DECODE, *WKV_TRAIN_CASES)
                and dtype == PATH_DTYPE["wkv6_fwd"]) \
                or (case in TWIN_WKV_CASES and dtype == torch.float32):
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
    checked against the plain version at LRU_TOL and timed both ways.  The
    serve twin's B5 shapes are timed in f32, as it runs them."""
    times = {}
    for name, case, dtype in (
            *((n, c, PATH_DTYPE[n]) for n, c in (
                ("rg_lru_fwd", LRU_PREFILL), ("rg_lru_fwd", LRU_DECODE),
                ("rg_lru_fwd", LRU_TRAIN), ("rg_lru_fwd", LRU_RANK), ("wkv6_fwd", WKV_PREFILL),
                ("wkv6_fwd", WKV_DECODE), ("wkv6_fwd", WKV_TRAIN), ("wkv6_fwd", WKV_RANK))),
            *(("wkv6_fwd", c, torch.float32) for c in TWIN_WKV_CASES)):
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
        + [(c, PATH_DTYPE["rg_lru_bwd"], None) for c in (LRU_TRAIN, LRU_RANK)] \
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
        if case in (LRU_TRAIN, LRU_RANK):
            errs[("rg_lru_bwd", case)] = max(e for e, _ in results)
    wkv_cases = [(c, dt, None) for c in WKV_CASES + [WKV_RAGGED] for dt in dtypes] \
        + [(c, PATH_DTYPE["wkv6_bwd"], None) for c in WKV_TRAIN_CASES] \
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
        if case in WKV_TRAIN_CASES:
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


def time_lru_bwd(case) -> dict:
    """B4' at a training shape (see time_recurrent_bwd)."""
    a, x, h0, gy, gh = lru_bwd_inputs(case, PATH_DTYPE["rg_lru_bwd"])
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
    print(f"rg_lru_bwd timing {case} {str(a.dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
          f"{t['device_ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms none (no PyTorch "
          f"call computes the gradient); torch.add moving its {3 * m * 4} bytes "
          f"yardstick_ms {t['yardstick_ms']:.4f} yardstick_device_ms "
          f"{t['yardstick_device_ms']:.4f}; bound_ms {t['bound_ms']:.4f} (by {t['bound_by']}: "
          f"{moved} bytes, {3 * n} FLOP)")
    return t


def time_recurrent_bwd() -> dict:
    """B4' and B5' at the training shapes, in the dtype the model runs them
    in: kernel (`ms`, `device_ms`) and plain version (fewer calls), beside the
    bound.  No single PyTorch call computes either; B4' is shown beside a
    torch.add that moves its bytes (`yardstick_ms`, `yardstick_device_ms`)."""
    times = {}
    for case in (LRU_TRAIN, LRU_RANK):
        times[("rg_lru_bwd", case)] = time_lru_bwd(case)
    for case in WKV_TRAIN_CASES:
        r, k, v, lw, u, s0, gy, gs = wkv_bwd_inputs(case, PATH_DTYPE["wkv6_bwd"])
        _, _, ws = wkv_kernel.wkv6_fwd(r, k, v, lw, u, s0)
        fns = {"ms": lambda: wkv_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy, gs, ws),
               "plain_ms": lambda: wkv_ref.wkv6_scan_bwd(r, k, v, lw, u, s0, gy, gs)}
        fns["device_ms"] = fns["ms"]
        t = time_in_turns(fns, {}, {"plain_ms": 1})
        moved, flops = wkv_bwd_work(r, v, s0, ws)
        t["bound_ms"], t["bound_by"] = bound(moved, flops, PEAK_FLOP_S[r.dtype])
        t["library_ms"] = t["library_device_ms"] = None
        times[("wkv6_bwd", case)] = t
        print(f"wkv6_bwd timing {case} {str(r.dtype)[6:]}: kernel_ms {t['ms']:.4f} device_ms "
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
    want = {"flash_attention_bwd_dkv": sum(k in ATTENTION_KINDS for k in kinds),
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


# the layer kinds that run B1 (and B2, B3 in training)
ATTENTION_KINDS = ("attn", "local", "mla")


def check_train_launches(path: str, kinds, steps: int, launches: dict, designs: dict) -> dict:
    """The launch counts of `steps` bf16 training steps of layers `kinds` at
    the training shape, checked; returns the counts a step.  Under either
    remat policy B1 and the recurrences' forward run twice a layer: "dots"
    saves only the projections' products, and recomputes the kernels."""
    attn = sum(k in ATTENTION_KINDS for k in kinds)
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


def full_config(tc):
    """`tc`'s model config, checked to be the arch's full published one (bf16,
    full remat)."""
    cfg = train_mod.model_config(tc)
    if (cfg.dtype, cfg.remat, cfg.remat_policy) != ("bfloat16", True, "full") \
            or cfg != configs.get(tc.arch):
        raise AssertionError(f"not the full config: {cfg}")
    return cfg


def backward_products(cfg, model, batch: dict) -> dict:
    """The matrix products (`aten::mm`, `aten::bmm`) that one backward of
    `model` on `batch` runs on the card, counted under torch.profiler: the
    gradients' products and what the remat recompute runs again.  A call
    that the selective-checkpoint context answers from its saved products
    still shows as an `aten::mm` event (the profiler records it as it
    enters the dispatcher), but launches no kernel: only the events with
    device time count as run ("calls" counts them all)."""
    loss, _ = loss_fn(cfg, model, batch)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        loss.backward()
        torch.cuda.synchronize()
    for p in model.parameters():
        p.grad = None
    counts = {}
    for op in ("aten::mm", "aten::bmm"):
        events = [e for e in prof.events() if e.name == op]
        counts[op] = sum(e.device_time_total > 0 for e in events)
        counts[f"{op} calls"] = len(events)
    return counts


def train_path(arch: str, num_layers: int | None,
               policy: str = "full") -> tuple[dict, list[float], dict | None]:
    """A main path: `arch` at its full published config (cut to `num_layers`
    where given, full width) trains TRAIN_STEPS steps through `train()`,
    under remat `policy` ("dots": a model whose config carries it, through
    `train()`'s model seam, drawn from the seed `train()` draws from).
    Returns the launch counts of the run, its losses and, for DOTS_ARCHS,
    the products one more backward runs (`backward_products`)."""
    b, seq = TRAIN_SHAPE.get(arch, (TRAIN_CASE[0], TRAIN_CASE[2]))
    tc = train_mod.TrainConfig(arch=arch, scale="full", steps=TRAIN_STEPS,
                               batch_size=b, seq_len=seq, grad_sync="bridge", seed=SEED)
    cfg = full_config(tc)
    model = None
    if num_layers is not None or policy != "full":
        cfg = dataclasses.replace(cfg, num_layers=num_layers or cfg.num_layers,
                                  remat_policy=policy)
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
    label = f"train {arch}" + (f" (remat {policy})" if policy != "full" else "")
    check_tensor_core_launches(label)
    peak = torch.cuda.max_memory_allocated()
    kinds = cfg.layer_kinds
    per_step = check_train_launches(label, kinds, TRAIN_STEPS, launches, designs)
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    dts = [float(re.search(r"dt ([0-9.]+)s", line).group(1)) for line in lines]
    timed = dts[1:]
    step_s = sum(timed) / len(timed)
    params = sum(p.numel() for p in trained.parameters())
    cut = "" if num_layers is None else \
        f" cut to {num_layers} of {configs.get(arch).num_layers} layers {kinds}"
    print(f"train {arch} full config{cut} "
          f"(bf16, remat {policy}, grad_sync bridge, 1 rank, {params} parameters), batch {b} x "
          f"{seq}: losses {losses}, warm-up step {dts[0]:.4f} s, timed steps {timed} s, mean "
          f"{step_s:.4f} s = {b * seq / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes), launches {launches} (per step {per_step}), "
          f"designs {designs}")
    products = None
    if arch in DOTS_ARCHS:
        host = SyntheticLM(cfg.vocab_size, seq, seed=SEED).global_batch(0, b, 1)
        products = backward_products(cfg, trained, {k: torch.from_numpy(v).cuda()
                                                    for k, v in host.items()})
        print(f"{label}: one more backward (batch {b} x {seq}) runs {products} "
              f"under torch.profiler")
    return launches, losses, products


def dots_against_full(arch: str, full: tuple, dots: tuple) -> None:
    """The "dots" run of `arch` against its "full" run from the same seed:
    the losses bit for bit (else, named, at rtol 1e-5), and the projections
    its backward no longer recomputes."""
    (_, full_losses, full_products), (_, dots_losses, dots_products) = full, dots
    same = full_losses == dots_losses
    print(f"train {arch} remat dots against full: losses {dots_losses} vs {full_losses}, "
          f"bit for bit {same}")
    if not same and not all(math.isclose(a, b, rel_tol=DOTS_LOSS_RTOL)
                            for a, b in zip(dots_losses, full_losses, strict=True)):
        raise AssertionError(f"{arch}: dots losses differ from full beyond {DOTS_LOSS_RTOL}")
    layers = configs.get(arch).num_layers
    drop = full_products["aten::mm"] - dots_products["aten::mm"]
    print(f"train {arch}: aten::mm in a backward {full_products['aten::mm']} (full) -> "
          f"{dots_products['aten::mm']} (dots), {drop} fewer = {drop / layers:.2f} a layer "
          f"over {layers}; aten::bmm {full_products['aten::bmm']} -> "
          f"{dots_products['aten::bmm']}")
    if drop <= 0 or dots_products["aten::bmm"] != full_products["aten::bmm"]:
        raise AssertionError(f"{arch}: dots recomputes {dots_products}, full {full_products}")


# --- the mesh paths: qwen3-moe on one card (phase 8), the rest on four (phase 9) ------

MOE_ARCH = "qwen3-moe-235b-a22b"
MESH_STEPS = 2            # steps of every mesh path
EP_A2A_PER_LAYER = 6      # dispatch and return, in the forward, its remat and the backward,
                          # for each group of a rank (groups run one after another)
PIPE_STAGES, PIPE_MICRO = 4, 4
PIPE_TOL = 1e-5           # tests/_distributed_worker.py check 4
ELASTIC_RTOL = 2e-3       # tests/_distributed_worker.py check 5
ELASTIC_LAYERS = 2


def mesh_tc(arch: str, mesh: tuple = (), axes: tuple = (), **kw):
    """A full-config gspmd run of MESH_STEPS steps at 8 x 512 on `mesh`."""
    b, _, seq = TRAIN_CASE[:3]
    return train_mod.TrainConfig(**{"arch": arch, "scale": "full", "steps": MESH_STEPS,
                                    "batch_size": b, "seq_len": seq, "grad_sync": "gspmd",
                                    "seed": SEED, "mesh_shape": mesh, "mesh_axes": axes} | kw)


def whole_params(model) -> list:
    """Every parameter whole on the host (a sharded one gathered: collective)."""
    from torch.distributed.tensor import DTensor

    return [(p.full_tensor() if isinstance(p, DTensor) else p).detach().cpu()
            for p in model.parameters()]


def mesh_train(tc, model, label: str, dev="cuda") -> dict:
    """`train()` with the launch counters and `bruck_all_to_all.calls` set to
    0 before and read after; checks the launches a step (tensor-core B1, B2
    and B3) and EP_A2A_PER_LAYER exchanges a MoE layer a step where the run
    has a 'model' axis.  Returns the losses, launches, exchanges, peak device
    memory and the trained model."""
    from repro_torch.collectives import bruck_all_to_all

    lines = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    bruck_all_to_all.calls = 0
    t0 = time.perf_counter()
    trained, opt_state, losses = train_mod.train(tc, progress=lines.append, device=dev,
                                                 model=model)
    wall = time.perf_counter() - t0
    launches, designs, calls = read_launches(), read_designs(), bruck_all_to_all.calls
    check_tensor_core_launches(label)
    kinds = trained.cfg.layer_kinds
    per_step = check_train_launches(label, kinds, len(losses), launches, designs)
    moe_layers = len(kinds) if trained.cfg.ffn == "moe" else 0
    # a rank's tokens form its own groups here (8 x 512 over at most 4 ranks,
    # groups of 1024), run one after another: an exchange pair for each
    ranks = math.prod(tc.mesh_shape) if tc.mesh_shape else 1
    m = trained.cfg.moe
    groups = 1 if m is None or m.vectorize_groups else \
        -(-tc.batch_size * tc.seq_len // ranks // m.group_size)
    want_calls = EP_A2A_PER_LAYER * moe_layers * groups * len(losses) \
        if "model" in tc.mesh_axes else 0
    if calls != want_calls:
        raise AssertionError(f"{label}: {calls} expert-parallel exchanges, expected {want_calls}")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    dts = [float(m.group(1)) for ln in lines if (m := re.search(r"dt ([0-9.]+)s", ln))]
    return {"losses": losses, "launches": launches, "per_step": per_step, "ep_a2a": calls,
            "peak": torch.cuda.max_memory_allocated(dev), "lines": lines, "step_s": dts,
            "wall_s": wall, "model": trained, "opt": opt_state}


def moe_mesh_path() -> dict:
    """Phase 8: qwen3-moe-235b-a22b at full width cut to 1 layer trains
    MESH_STEPS steps (gspmd, bf16, full remat, 8 x 512) unsharded, then on a
    (1, 1) ("data", "model") mesh (parameters and moments as DTensors, the
    experts' exchange through bruck_all_to_all over a group of one), one
    after the other; the two must give the same losses and final parameters
    bit for bit."""
    tc = mesh_tc(MOE_ARCH)
    cfg = dataclasses.replace(full_config(tc), num_layers=1)
    runs, finals = {}, {}
    for name, mesh in (("unsharded", {}),
                       ("mesh (1, 1)", {"mesh_shape": (1, 1), "mesh_axes": ("data", "model")})):
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        params = sum(p.numel() for p in model.parameters())
        run = mesh_train(dataclasses.replace(tc, **mesh), model, f"train {MOE_ARCH} {name}")
        finals[name] = whole_params(run.pop("model"))
        del model, run["opt"]
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = run
        print(f"train {MOE_ARCH} full width cut to 1 layer, {name} ({params} parameters, bf16, "
              f"remat full, gspmd, 1 card), batch 8 x 512: losses {run['losses']}, steps "
              f"{run['step_s']} s, peak memory {run['peak'] / 2**30:.3f} GiB ({run['peak']} "
              f"bytes; reckoning {params} x 12 B = {params * 12 / 2**30:.3f} GiB of state), "
              f"launches a step {run['per_step']}, expert-parallel exchanges "
              f"(bruck_all_to_all calls) {run['ep_a2a']}", flush=True)
    a, b = runs["unsharded"], runs["mesh (1, 1)"]
    same = all(torch.equal(x, y) for x, y in
               zip(finals["unsharded"], finals["mesh (1, 1)"], strict=True))
    print(f"train {MOE_ARCH}: mesh (1, 1) against unsharded: losses bit-identical "
          f"{a['losses'] == b['losses']}, final parameters bit-identical {same}")
    if a["losses"] != b["losses"] or not same:
        raise AssertionError(f"{MOE_ARCH} on a (1, 1) mesh differs from the unsharded run: "
                             f"{b['losses']} against {a['losses']}")
    del finals
    gc.collect()
    return runs


def rank_memory(dev) -> list[int]:
    """Every rank's peak device memory since the last reset."""
    import torch.distributed as dist

    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(dev))
    return peaks


def mesh_moe(n: int, dev, say, layers: int) -> dict:
    """Check 3 on the cards: qwen3-moe at full width cut to `layers` layers on
    a (2, 2) ("data", "model") mesh, MESH_STEPS gspmd steps; each rank holds
    its shards, splits the attention's heads with its 'model' peer (tensor
    parallelism), cuts the shared rows' tokens between them and runs half
    the experts on both peers' slots."""
    tc = mesh_tc(MOE_ARCH, (2, 2), ("data", "model"))
    cfg = dataclasses.replace(full_config(tc), num_layers=layers)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    params = sum(p.numel() for p in model.parameters())
    per_layer = sum(p.numel() for p in model.blocks[0].parameters())
    experts = sum(model.blocks[0].ffn[k].numel() for k in ("w_gate", "w_up", "w_down"))
    run = mesh_train(tc, model, f"train {MOE_ARCH} (2, 2) {layers} layers", dev)
    del model, run["model"], run["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    peaks = rank_memory(dev)
    state = params * 12 / n
    gathered = experts // 2 * 2   # one block's experts: half of E a rank, 2 bytes each
    say(f"mesh train {MOE_ARCH} full width cut to {layers} layers on (2, 2) (data, model), "
        f"{n} cards, {params} parameters ({per_layer} a layer), bf16, remat full, gspmd, "
        f"global batch 8 x 512: losses {run['losses']}, steps {run['step_s']} s, launches a "
        f"step {run['per_step']}, expert-parallel exchanges {run['ep_a2a']}; peak memory a card "
        f"{[round(x / 2**30, 3) for x in peaks]} GiB ({peaks} bytes) against the reckoning "
        f"{params} x 12 B / {n} = {state / 2**30:.3f} GiB of state + one block's gathered "
        f"experts {gathered / 2**30:.3f} GiB + activations")
    return {k: run[k] for k in ("losses", "launches", "per_step", "ep_a2a", "step_s")} \
        | {"peaks": peaks, "params": params}


def time_ep_exchange(dev, say) -> dict:
    """The expert-parallel exchange of one rank's payload on (2, 2): its one
    group's (E, C, d) bf16 slots as (2, E/2, C, d) over the 2-rank 'model'
    group, bruck_all_to_all against dist.all_to_all_single (the same bits),
    on the host clock, median of 9 rounds of 5."""
    import torch.distributed as dist

    from repro_torch.collectives import bruck_all_to_all
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.get(MOE_ARCH)
    m = cfg.moe
    c = moe_mod._capacity(m.group_size, m)
    group = make_mesh((2, 2), ("data", "model"), dev).get_group("model")
    gen = torch.Generator(device=dev).manual_seed(SEED + dist.get_rank())
    x = torch.randn((2, m.num_experts // 2, c, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    want = torch.empty_like(x)
    dist.all_to_all_single(want, x, group=group)
    if not torch.equal(bruck_all_to_all(x, group), want):
        raise AssertionError("the EP exchange differs from all_to_all_single")
    recv = torch.empty_like(x)
    rounds = {"bruck": [], "library": []}
    for _ in range(9):
        rounds["library"].append(host_ms(
            lambda: dist.all_to_all_single(recv, x, group=group), 5))
        rounds["bruck"].append(host_ms(lambda: bruck_all_to_all(x, group), 5))
    ms = {k: sorted(v)[4] for k, v in rounds.items()}
    say(f"mesh EP exchange {MOE_ARCH}: one rank's slots ({m.num_experts}, C = {c}, "
        f"{cfg.d_model}) bf16 = {x.numel() * 2} bytes over the 2-rank model group: "
        f"bruck_all_to_all equals all_to_all_single bit for bit; host clock ms, median of 9 "
        f"x 5: {ms} (rounds {rounds})")
    return {"bytes": x.numel() * 2, "ms": ms}


# a TP run's first loss against one card's forward (the whole models), and two
# TP layouts' first losses (command-r-plus-104b), 2.7 and 4.7 times their
# readings on the H100 (PERF.md section 6); rwkv6-3b's is the 2e-4 of the mesh tests
# (tests/test_torch_mesh.py), met at 1.985e-4: its bf16 forward is the most
# sensitive to rounding (PERF.md section 7)
TP_LOSS_RTOL = {"recurrentgemma-9b": 3e-5, "rwkv6-3b": 2e-4, "command-r-plus-104b": 3e-5}
TP_AXES = ("data", "model")
TP_SERVE_ARCH = "command-r-plus-104b"
TP_PARITY_LAYERS, TP_PARITY_PROMPT, TP_PARITY_STEPS = 2, 256, 4
TP_TRAIN_PARITY_LAYERS = 2
TP_CR_TRAIN_LAYERS = 4
# command-r-plus-104b's peaks a card with the logits gathered whole in f32, before
# the vocab-parallel loss and greedy pick (PERF.md section 6): trained at
# TP_CR_TRAIN_LAYERS, and served whole on (1, 4)
GATHERED_PEAK_GIB = {"2x2": 62.361, "1x4": 56.501}
GATHERED_SERVE_PEAK_GIB = 55.198


def tp_whole(arch: str, shape: tuple, n: int, dev, say) -> dict:
    """`arch` whole at full width trained MESH_STEPS gspmd steps (bf16, full
    remat, 8 x 512) on a `shape` ("data", "model") mesh, the projections
    split over 'model'; its first loss against one card's forward `loss_fn`
    of the same weights and global batch (rank 0, before the run) at
    TP_LOSS_RTOL, the launches a step checked against its layers.  Rank 0
    also prints the f32 forward of the same draw beside one card's bf16
    forward: the bf16 rounding error of the model itself."""
    import torch.distributed as dist

    tc = mesh_tc(arch, shape, TP_AXES)
    cfg = full_config(tc)
    rank = dist.get_rank()
    reference = None
    if rank == 0:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        b, _, seq = TRAIN_CASE[:3]
        batch = SyntheticLM(cfg.vocab_size, seq, seed=tc.seed).global_batch(0, b, 1)
        with torch.no_grad():
            loss, _ = loss_fn(cfg, model, {k: torch.from_numpy(v).to(dev)
                                           for k, v in batch.items()})
        reference = float(loss)
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")  # the same draw, not rounded
        model = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED), dev)
        with torch.no_grad():
            loss, _ = loss_fn(cfg32, model, {k: torch.from_numpy(v).to(dev)
                                             for k, v in batch.items()})
        f32 = float(loss)
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    run = mesh_train(tc, None, f"train {arch} whole on {shape}", dev)
    params = sum(p.numel() for p in run["model"].parameters())
    del run["model"], run["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    peaks = rank_memory(dev)
    out = {k: run[k] for k in ("losses", "launches", "per_step", "step_s")} | {
        "peaks": peaks, "params": params}
    if rank == 0:
        diff = abs(run["losses"][0] - reference) / abs(reference)
        say(f"mesh train {arch} whole ({cfg.num_layers} layers, {params} parameters) on {shape} "
            f"(data, model; tensor parallel), bf16, remat full, gspmd, global batch 8 x 512: "
            f"losses {run['losses']}, steps {run['step_s']} s, launches a step "
            f"{run['per_step']}; first loss against one card's forward loss_fn {reference}: "
            f"relative difference {diff:.3e} (rtol {TP_LOSS_RTOL[arch]}); one card's bf16 "
            f"forward against the f32 forward of the same draw {f32}: relative "
            f"{abs(reference - f32) / abs(f32):.3e}; peak memory a card "
            f"{[round(x / 2**30, 3) for x in peaks]} GiB ({peaks} bytes) against "
            f"{params} x 12 B / {n} = {params * 12 / n / 2**30:.3f} GiB of state")
        if diff > TP_LOSS_RTOL[arch]:
            raise AssertionError(f"{arch} on {shape}: first loss {run['losses'][0]} against "
                                 f"one card's {reference}")
        out["reference_loss"], out["f32_loss"] = reference, f32
    return out


def tp_prompts(cfg, prompt_len: int, batch: int = 4) -> torch.Tensor:
    """serve_path's prompts: the same seed on every rank."""
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=torch.Generator().manual_seed(SEED + 2), dtype=torch.int32)


def tp_greedy(cfg, model, prompts, steps: int, max_seq: int, dev):
    """Prefill and `steps` - 1 greedy decode steps: (the logits of each, (B,
    V) f32 on the host; the ids (B, steps))."""
    logits, caches = prefill(cfg, model, {"tokens": prompts.to(dev)}, max_seq)
    out = [logits.float().cpu()]
    for _ in range(steps - 1):
        logits, caches = decode_step(cfg, model, torch.argmax(logits, -1)[:, None], caches)
        out.append(logits.float().cpu())
    return out, torch.stack([x.argmax(-1) for x in out], 1)


def tp_serve_parity(n: int, dev, say) -> dict:
    """Tensor-parallel serving against one card: command-r-plus-104b at full
    width cut to TP_PARITY_LAYERS in f32, 4 prompts of TP_PARITY_PROMPT,
    prefill and TP_PARITY_STEPS - 1 decode steps; rank 0 alone first
    (unsharded), then the n ranks on (1, n) from the sharded init of the same
    seed: the logits at MODEL_TOL and the same ids.  Then the bf16 model at
    phase 7's depth (SERVE_DEPTH) on (1, n) through `serve_requests`, its ids
    beside phase 7's one-card ids (CHIP_SMOKE_SERVED): the agreement, and in
    each request the first position where they part and, from the TP model's
    forward over the prompt and one card's ids, the logit of the TP run's
    token there less that of one card's (printed, not gated)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import activation_rules, init_sharded
    from repro_torch.models.sharding import activation_sharding

    rank, arch = dist.get_rank(), TP_SERVE_ARCH
    cfg = dataclasses.replace(configs.get(arch), num_layers=TP_PARITY_LAYERS, dtype="float32")
    prompts = tp_prompts(cfg, TP_PARITY_PROMPT)
    max_seq = TP_PARITY_PROMPT + TP_PARITY_STEPS + 1
    want = None
    if rank == 0:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        with torch.inference_mode():
            want = tp_greedy(cfg, model, prompts, TP_PARITY_STEPS, max_seq, dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh((1, n), TP_AXES, dev)
    model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh,
                         fsdp=False)
    reset_launches()
    with torch.inference_mode(), activation_sharding(mesh, activation_rules(mesh)):
        got = tp_greedy(cfg, model, prompts, TP_PARITY_STEPS, max_seq, dev)
    launches = read_launches()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got[1].tolist())
    out = {"launches": launches}
    if rank == 0:
        errs = [max_err(g, w, MODEL_TOL, MODEL_TOL) for g, w in zip(got[0], want[0], strict=True)]
        same_ids = torch.equal(got[1], want[1]) and all(x == every[0] for x in every)
        say(f"mesh serve parity {arch} ({TP_PARITY_LAYERS} layers, f32, 4 x "
            f"({TP_PARITY_PROMPT} + {TP_PARITY_STEPS})) on (1, {n}) against one card: logits "
            f"max|err| prefill and decode steps {[round(e, 8) for e, _ in errs]} (tol "
            f"{MODEL_TOL} + {MODEL_TOL}|want|), ids equal to one card's and on every rank "
            f"{same_ids}; a rank's launches {launches}")
        if not all(ok for _, ok in errs) or not same_ids:
            raise AssertionError(f"{arch}: tensor-parallel serving differs from one card")
        out["errs"] = [e for e, _ in errs]

    # the bf16 model at phase 7's depth, beside phase 7's ids
    depth = SERVE_DEPTH[arch]
    cfg = dataclasses.replace(configs.get(arch), num_layers=depth)
    model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh,
                         fsdp=False)
    prompts = tp_prompts(cfg, 512)
    reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=32) for i in range(4)]
    one_card = json.loads(Path(os.environ["CHIP_SMOKE_SERVED"]).read_text())[arch]
    with activation_sharding(mesh, activation_rules(mesh)):
        ids = serve_requests(cfg, model, reqs, max_seq=512 + 32 + 1,
                             progress=lambda *_: None, device=dev)
        seq = torch.cat([prompts, torch.tensor([one_card[str(i)] for i in range(4)],
                                               dtype=prompts.dtype)], 1)
        with torch.inference_mode():  # token j of a request is read at position 511 + j
            logits = forward(cfg, model, {"tokens": seq.to(dev)}, mode="train").logits
    first, margins = [], []
    for i in range(4):
        j = next((j for j, (a, b) in enumerate(zip(ids[i], one_card[str(i)], strict=True))
                  if a != b), None)
        first.append(j)
        if j is not None:
            row = logits[i, 511 + j].float()
            margins.append(round(float(row[ids[i][j]] - row[one_card[str(i)][j]]), 4))
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        agree = sum(a == b for i in range(4) for a, b in zip(ids[i], one_card[str(i)],
                                                            strict=True)) / (4 * 32)
        say(f"mesh serve {arch} ({depth} layers, bf16, 4 x (512 + 32)) on (1, {n}) beside "
            f"phase 7's one card: ids agree at {agree * 100:.1f} % of positions (not gated); "
            f"the first position where they part in each request (of 32; None: none) {first}; "
            f"there, the TP model's logit of its own token less that of one card's token, on "
            f"one card's context: {margins}")
        out |= {"agreement": agree, "first_divergence": first, "margins": margins}
    return out


def tp_serve_whole(n: int, dev, say) -> dict:
    """command-r-plus-104b whole (64 layers, bf16) served on (1, n): the
    sharded init (fsdp=False, the reference's serve-tp-params), 4 requests of
    512-token prompts and 32 new tokens through `serve_requests` inside
    `activation_sharding`; every rank the same ids, finite logits, B1 once a
    layer a prefill (tensor-core) at the local heads, each card's peak;
    prefill and decode tok/s and one decode step under the profiler."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import activation_rules, init_sharded
    from repro_torch.models.sharding import activation_sharding

    arch, rank = TP_SERVE_ARCH, dist.get_rank()
    cfg = configs.get(arch)
    mesh = make_mesh((1, n), TP_AXES, dev)
    rules = activation_rules(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh,
                         fsdp=False)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    held = sum(p.to_local().numel() * p.to_local().element_size() for p in model.parameters())
    prompt_len, new_tokens, batch = 512, 32, 4
    max_seq = prompt_len + new_tokens + 1
    prompts = tp_prompts(cfg, prompt_len, batch)
    reqs = [Request(rid=i, prompt=prompts[i].numpy(), max_new_tokens=new_tokens)
            for i in range(batch)]
    want_prefill, want_decode = expected_serve_launches(cfg, new_tokens)
    per_step = {k: v // (new_tokens - 1) for k, v in want_decode.items()}
    runs = {}
    for graph in (True, False):  # the decode step captured (every rank the same), then eager
        messages, at_prefill = [], {}

        def progress(msg):
            if not messages:
                at_prefill.update(read_launches())
            messages.append(msg)

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        reset_launches()
        with activation_sharding(mesh, rules):
            out = serve_requests(cfg, model, reqs, max_seq=max_seq, progress=progress,
                                 device=dev, graph=graph)
        total = read_launches()
        way = "graph" if graph else "eager"
        replays = replays_of(messages[1])
        if graph != (replays is not None):
            raise AssertionError(f"{arch} on (1, {n}), {way}: decode {messages[1]!r}")
        check_tensor_core_launches(f"serve {arch} on (1, {n}) rank {rank}, {way}")
        launches = {"prefill": dict(at_prefill),
                    "decode": {k: total[k] - at_prefill[k] for k in total}}
        # a captured run's counters see its warm-up step and its capture, not its replays
        want = {k: 2 * v for k, v in per_step.items()} if graph else want_decode
        if launches["prefill"] != want_prefill or launches["decode"] != want:
            raise AssertionError(f"{arch} on (1, {n}), {way}: launches {launches}, expected "
                                 f"prefill {want_prefill}, decode {want}")
        ids = [out[i] for i in range(batch)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, ids)
        if not all(x == ids for x in every):
            raise AssertionError(f"{arch} on (1, {n}), {way}: the ranks returned different ids")
        runs[way] = {"ids": ids, "launches": launches, "messages": messages,
                     "peak": torch.cuda.max_memory_allocated(dev),
                     "replays": replays,
                     "prefill_s": float(re.search(r"prefill: .* in ([0-9.]+)s",
                                                  messages[0]).group(1)),
                     "decode_tps": float(re.search(r"\(([0-9.]+) tok/s\)",
                                                   messages[1]).group(1)),
                     "replay_tps": replay_rate(messages[1], batch)}
    if runs["graph"]["ids"] != runs["eager"]["ids"]:
        raise AssertionError(f"{arch} on (1, {n}): the captured step's ids differ from the "
                             f"eager loop's")
    ids, launches, messages = runs["graph"]["ids"], runs["graph"]["launches"], \
        runs["graph"]["messages"]
    serve_peak = runs["graph"]["peak"]
    with torch.inference_mode(), activation_sharding(mesh, rules):
        # the greedy ids of the vocab-parallel argmax against the gathered logits'
        local, caches = prefill(cfg, model, {"tokens": prompts.to(dev)}, max_seq,
                                logits_whole=False)
        picks = []
        for _ in range(4):
            vp, whole = greedy(cfg, model, local), torch.argmax(tp_mod.gather(local, -1), -1)
            picks.append((vp.tolist(), whole.tolist()))
            local, caches = decode_step(cfg, model, vp[:, None], caches, logits_whole=False)
        del caches
        logits, caches = prefill(cfg, model, {"tokens": prompts.to(dev)}, max_seq)
        finite = bool(torch.isfinite(logits).all())
        kv = tuple(caches[0]["mix"]["k"].shape)
        step = torch.tensor([[t[0]] for t in ids], device=dev)
        decode_step(cfg, model, step, caches)
        prof = profiled(lambda: decode_step(cfg, model, step, caches))
        del caches, logits
        # one replay of the captured step under the profiler: its NCCL time
        _, caches = prefill(cfg, model, {"tokens": prompts.to(dev)}, max_seq,
                            logits_whole=False)
        cap = CapturedDecode(cfg, model, caches, step)
        cap.step()
        prof_graph = profiled(cap.step, by_kernel=True)
        del cap
    # the captured run's decode launches: its warm-up step's, and a replay's
    # hand-written kernels counted by name in the profiled replay, each replay
    replayed, _ = wrapper_launches(prof_graph["kernels"])
    if replayed != {w: per_step[w] for w in WRAPPER_KERNELS}:
        raise AssertionError(f"{arch} on (1, {n}): the profiled replay launched {replayed}, "
                             f"one step launches {per_step}")
    launches["decode"].update({w: per_step[w] + k * runs["graph"]["replays"]
                               for w, k in replayed.items()})
    if launches["decode"] != want_decode:
        raise AssertionError(f"{arch} on (1, {n}): the captured run's decode launches "
                             f"{launches['decode']}, expected {want_decode}")
    if not finite:
        raise AssertionError(f"{arch} on (1, {n}): non-finite logits")
    if any(vp != whole for vp, whole in picks):
        raise AssertionError(f"{arch} on (1, {n}): vocab_parallel_argmax's ids differ from "
                             f"the gathered logits' argmax: {picks}")
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    init_peaks, serve_peaks = rank_memory_of(init_peak), rank_memory_of(serve_peak)
    eager_peaks = rank_memory_of(runs["eager"]["peak"])
    prefill_s, decode_tps = runs["graph"]["prefill_s"], runs["graph"]["decode_tps"]
    say(f"mesh serve {arch} whole ({cfg.num_layers} layers, {cfg.param_count()} parameters, "
        f"bf16) on (1, {n}) (tensor parallel, fsdp=False), {batch} x ({prompt_len} + "
        f"{new_tokens}): sharded init {init_s:.1f} s; prefill {prefill_s:.3f} s = "
        f"{batch * prompt_len / prefill_s:.1f} tok/s, decode {decode_tps:.1f} tok/s; every rank "
        f"the same ids; the greedy ids of vocab_parallel_argmax equal the gathered logits' "
        f"argmax at the prefill and 3 decode steps ({4 * batch} ids); logits finite; a rank's "
        f"KV cache {kv} a layer; launches a rank "
        f"prefill {launches['prefill']}, decode {launches['decode']}; parameters held a card "
        f"{held} bytes; peak memory a card, init {[round(x / 2**30, 3) for x in init_peaks]} "
        f"GiB ({init_peaks} bytes), serving {[round(x / 2**30, 3) for x in serve_peaks]} GiB "
        f"({serve_peaks} bytes; with the prefill's logits gathered whole: "
        f"{GATHERED_SERVE_PEAK_GIB} GiB); decode step (batch {batch}) under the profiler, rank 0: "
        f"{profile_text(prof)}")
    say(f"mesh serve {arch} whole on (1, {n}), the decode step captured as a CUDA graph "
        f"({runs['graph']['replays']} replays) and eager, ids equal both ways on every rank: "
        f"decode tok/s graph {runs['graph']['decode_tps']} (the replays alone "
        f"{runs['graph']['replay_tps']}), eager {runs['eager']['decode_tps']}; "
        f"prefill s graph {runs['graph']['prefill_s']}, eager {runs['eager']['prefill_s']}; "
        f"serving peak a card, eager {[round(x / 2**30, 3) for x in eager_peaks]} GiB "
        f"({eager_peaks} bytes); one replay under the profiler, rank 0: "
        f"{profile_text(prof_graph)}")
    prof.pop("kernels")
    prof_graph.pop("kernels")
    return {"launches": launches["prefill"], "decode_launches": launches["decode"],
            "ids": ids, "prefill_s": prefill_s, "decode_tps": decode_tps, "held": held,
            "init_peaks": init_peaks, "serve_peaks": serve_peaks, "profile": prof,
            "eager_decode_tps": runs["eager"]["decode_tps"], "eager_peaks": eager_peaks,
            "replay_profile": prof_graph}


def rank_memory_of(value: int) -> list[int]:
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return every


def tp_train_parity(n: int, dev, say) -> dict:
    """Tensor-parallel training against one card: stablelm-3b at full width
    cut to TP_TRAIN_PARITY_LAYERS, f32, phase 6's batch (2 x 128), on (2, 2)
    and on (1, n), from the sharded init of the seed; the loss and every
    gradient leaf gathered whole against rank 0's unsharded run of the same
    weights and batch at phase 6's bound (1e-4 + 1e-4 |want|), and every
    gradient the rule table replicates over 'model' the same bits on each
    'model' peer.  On the same weights and batch, the sequence-parallel
    step against the TP step (the loss within SP_LOSS_RTOL, every gradient
    element within SP_GRAD_ATOL, replicated gradients the same bits on each
    peer) and, on (1, n), the vocab-parallel loss against the loss on the
    gathered logits, the path it replaced (`gathered_loss`; the loss and
    every gradient element within VOCAB_TOL + VOCAB_TOL |want|)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import activation_rules, init_sharded
    from repro_torch.models.sharding import activation_sharding

    arch, rank = "stablelm-3b", dist.get_rank()
    cfg = dataclasses.replace(configs.get(arch), num_layers=TP_TRAIN_PARITY_LAYERS,
                              dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, 128, seed=SEED).global_batch(0, 2, 1).items()}
    want = None
    if rank == 0:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        loss, _ = loss_fn(cfg, model, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        want = (loss.item(), [p.grad.cpu() for p in model.parameters()])
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out = {}
    for shape in ((2, 2), (1, n)):
        mesh = make_mesh(shape, TP_AXES, dev)
        model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh)
        tc = train_mod.TrainConfig(arch=arch, batch_size=2, grad_sync="gspmd",
                                   mesh_shape=shape, mesh_axes=TP_AXES)
        lay = train_mod.layout(tc, train_mod.current_world(), mesh)
        per = 2 // lay.rows.size
        rows = {k: v[lay.rows.rank * per:(lay.rows.rank + 1) * per].to(dev)
                for k, v in batch.items()}
        model_group, model_dim = mesh.get_group("model"), 1
        runs = {"tp": (False, lambda: loss_fn(cfg, model, rows)[0]),
                "sp": (True, lambda: loss_fn(cfg, model, rows)[0])}
        if shape[1] == n:
            runs["gathered"] = (False, lambda: gathered_loss(cfg, model, rows))
        got = {}
        for name, (seq, fn) in runs.items():
            for p in model.parameters():
                p.grad = None
            reset_launches()
            with activation_sharding(mesh, activation_rules(mesh, seq), lay.split):
                loss = fn()
                loss.backward()
            launches = read_launches()
            total = loss.detach().clone()
            dist.all_reduce(total, group=lay.rows.group)
            unequal = []
            for pname, p in model.named_parameters():
                if isinstance(p.placements[model_dim], Replicate):
                    g = p.grad.to_local().contiguous()
                    peers = [torch.empty_like(g) for _ in range(dist.get_world_size(model_group))]
                    dist.all_gather(peers, g, group=model_group)
                    if not all(torch.equal(peers[0], x) for x in peers):
                        unequal.append(pname)
            got[name] = (total.item() / lay.rows.size, unequal, launches,
                         [(p.grad.full_tensor() / lay.rows.size).cpu()
                          for p in model.parameters()])
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
        if rank != 0:
            if got["tp"][1] or got["sp"][1]:
                raise AssertionError(f"rank {rank}: replicated gradients differ: "
                                     f"{got['tp'][1]}, {got['sp'][1]}")
            continue
        got_loss, unequal, launches, grads = got["tp"]
        errs = [max_err(g, w, TRAIN_GRAD_RTOL, TRAIN_GRAD_RTOL)
                for g, w in zip(grads, want[1], strict=True)]
        worst = max(e for e, _ in errs)
        loss_diff = abs(got_loss - want[0]) / abs(want[0])
        say(f"mesh train parity {arch} ({TP_TRAIN_PARITY_LAYERS} layers, f32, 2 x 128) on "
            f"{shape} against one card: loss {got_loss:.7f} against {want[0]:.7f} "
            f"(relative {loss_diff:.3e}, rtol {TRAIN_LOSS_RTOL}); gradients of "
            f"{len(grads)} leaves, worst max|err| {worst:.3e} (tol {TRAIN_GRAD_RTOL} + "
            f"{TRAIN_GRAD_RTOL}|want|); gradients replicated over 'model' that differ "
            f"between peers {unequal}; a rank's launches {launches}")
        if loss_diff > TRAIN_LOSS_RTOL or not all(ok for _, ok in errs) or unequal:
            raise AssertionError(f"{arch} on {shape}: tensor-parallel training differs "
                                 f"from one card")
        key = "x".join(map(str, shape))
        out[key] = {"loss_diff": loss_diff, "worst": worst, "launches": launches}
        sp_loss = abs(got["sp"][0] - got_loss) / abs(got_loss)
        sp_grad = max(float((g - w).abs().max())
                      for g, w in zip(got["sp"][3], grads, strict=True))
        say(f"mesh sp parity {arch} ({TP_TRAIN_PARITY_LAYERS} layers, f32, 2 x 128) on {shape}: "
            f"the sequence-parallel step's loss {got['sp'][0]:.8f} against TP's {got_loss:.8f} "
            f"(relative {sp_loss:.3e}, tol {SP_LOSS_RTOL}), worst gradient element "
            f"{sp_grad:.3e} (tol {SP_GRAD_ATOL}); replicated gradients that differ between "
            f"peers {got['sp'][1]}; a rank's launches {got['sp'][2]}")
        out[key] |= {"sp_loss": sp_loss, "sp_grad": sp_grad}
        if sp_loss > SP_LOSS_RTOL or sp_grad > SP_GRAD_ATOL or got["sp"][1]:
            raise AssertionError(f"{arch} on {shape}: the sequence-parallel step differs "
                                 f"from the TP step")
        if "gathered" in got:
            vp_loss = abs(got_loss - got["gathered"][0]) / abs(got["gathered"][0])
            errs = [max_err(g, w, VOCAB_TOL, VOCAB_TOL)
                    for g, w in zip(grads, got["gathered"][3], strict=True)]
            vp_grad = max(e for e, _ in errs)
            say(f"mesh vocab-parallel loss {arch} on {shape}: {got_loss:.8f} against the "
                f"gathered logits' {got['gathered'][0]:.8f} (relative {vp_loss:.3e}, tol "
                f"{VOCAB_TOL}), worst gradient max|err| {vp_grad:.3e} (tol {VOCAB_TOL} + "
                f"{VOCAB_TOL}|want|)")
            out[key] |= {"vp_loss": vp_loss, "vp_grad": vp_grad}
            if vp_loss > VOCAB_TOL or not all(ok for _, ok in errs):
                raise AssertionError(f"{arch} on {shape}: the vocab-parallel loss differs "
                                     f"from the gathered logits'")
    return out


def tp_command_r_train(n: int, dev, say) -> dict:
    """command-r-plus-104b at full width cut to TP_CR_TRAIN_LAYERS trained
    MESH_STEPS gspmd steps (bf16, full remat, 8 x 512) on (2, 2) and on
    (1, n), each with and without sequence parallelism: more parameters
    and moments than one card holds (12 B a parameter).  Its losses finite,
    the two layouts' first losses within TP_LOSS_RTOL[arch], and each
    layout's sequence-parallel first loss within it of the layout's own;
    each card's peak beside the one with the logits gathered whole, and
    the step times."""
    import torch.distributed as dist

    arch, rank = TP_SERVE_ARCH, dist.get_rank()
    out = {}
    for shape in ((2, 2), (1, n)):
        tc = mesh_tc(arch, shape, TP_AXES)
        cfg = dataclasses.replace(full_config(tc), num_layers=TP_CR_TRAIN_LAYERS)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        params = sum(p.numel() for p in model.parameters())
        run = mesh_train(tc, model, f"train {arch} {TP_CR_TRAIN_LAYERS} layers on {shape}", dev)
        del model, run["model"], run["opt"]
        gc.collect()
        torch.cuda.empty_cache()
        peaks = rank_memory(dev)
        key = "x".join(map(str, shape))
        out[key] = {k: run[k] for k in ("losses", "launches", "per_step", "step_s")} | {
            "peaks": peaks, "params": params}
        say(f"mesh train {arch} full width cut to {TP_CR_TRAIN_LAYERS} of 64 layers on {shape} "
            f"(tensor parallel, the vocab-parallel loss), {params} parameters "
            f"({params * 12 / 1e9:.1f} GB of parameters and moments, "
            f"{params * 12 / n / 1e9:.1f} GB a card), bf16, remat full, gspmd, 8 x 512: losses "
            f"{run['losses']}, steps {run['step_s']} s, launches a step {run['per_step']}; peak "
            f"memory a card {[round(x / 2**30, 3) for x in peaks]} GiB ({peaks} bytes; with "
            f"the logits gathered whole: {GATHERED_PEAK_GIB[key]} GiB)")
        sp = sp_mesh_train(tc, cfg, f"train {arch} {TP_CR_TRAIN_LAYERS} layers on {shape}, "
                           f"sequence parallel", dev, probe=True)
        diff = abs(sp["losses"][0] - run["losses"][0]) / abs(run["losses"][0])
        out[key + " sp"] = sp | {"diff": diff}
        say(f"mesh train {arch} {TP_CR_TRAIN_LAYERS} layers on {shape} with sequence "
            f"parallelism: losses {sp['losses']} (first against the TP step's: relative "
            f"{diff:.3e}, rtol {TP_LOSS_RTOL[arch]}), steps {sp['step_s']} s, peak memory a card "
            f"{[round(x / 2**30, 3) for x in sp['peaks']]} GiB ({sp['peaks']} bytes); after the "
            f"steps a card holds {[round(x / 2**30, 3) for x in sp['held']]} GiB, and one more "
            f"forward and backward alone (no AdamW) peaks at "
            f"{[round(x / 2**30, 3) for x in sp['fwd_bwd_peaks']]} GiB")
        if diff > TP_LOSS_RTOL[arch]:
            raise AssertionError(f"{arch} on {shape}: the sequence-parallel first loss "
                                 f"{sp['losses'][0]} against {run['losses'][0]}")
    a, b = out["2x2"]["losses"][0], out[f"1x{n}"]["losses"][0]
    diff = abs(a - b) / abs(b)
    if rank == 0:
        say(f"mesh train {arch}: first loss on (2, 2) {a} against (1, {n}) {b}, relative "
            f"{diff:.3e} (rtol {TP_LOSS_RTOL[arch]})")
    if diff > TP_LOSS_RTOL[arch]:
        raise AssertionError(f"{arch}: the two layouts' first losses differ: {a}, {b}")
    return out


# --- the rest of the 'model' axis: sequence parallelism, the vocab-parallel loss
# and greedy pick, TP inside the experts, the combine over sharded caches -----------

SP_LOSS_RTOL = 1e-6       # f32: the SP step against the TP step, its loss (relative)
SP_GRAD_ATOL = 1e-5       # and every gradient element
VOCAB_TOL = 1e-6          # the vocab-parallel loss and gradients against the gathered logits'
COMBINE_TOL = 1e-4        # f32 decode logits through the sharded caches against one card's
# the combine's f32 cases: (layers, the dry run's variant, config cuts); recurrentgemma-9b's
# first local-attention layer is its third, and a window of 64 under a 100-slot cache
# wraps its ring buffer
COMBINE_CASES = {"recurrentgemma-9b": (3, "kv-seq-sharded", {"window": 64}),
                 "minicpm3-4b": (2, "baseline", {})}
COMBINE_PROMPT, COMBINE_STEPS = 96, 4
COMBINE_SERVE_SEQ = 548   # phase 7's 512 + 32 (+ 1 rounded up so the sequence divides by 4)
COMBINE_SERVE_TOKENS = 16  # of phase 7's 32 ids, compared (the phase's time)


def gathered_loss(cfg, model, batch):
    """`loss_fn` as it was before the vocab-parallel loss: the logits gathered
    whole over 'model' (f32, (rows, S, V) on every peer), the whole-vocab
    logsumexp and gold logit."""
    out = forward(cfg, model, batch, mode="train")
    labels = batch["labels"].long()
    logits = out.logits[:, -labels.shape[1]:, :].float()
    per = torch.logsumexp(logits, -1) - torch.gather(logits, -1,
                                                     labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum(per * mask) / torch.clamp_min(mask.sum(), 1.0) + 0.01 * out.aux_loss


def sp_mesh_train(tc, cfg, label: str, dev, seq_parallel: bool = True,
                  experts: str = "model", probe: bool = False) -> dict:
    """`train()`'s gspmd loop on `tc`'s mesh with the step of
    `make_train_step(..., seq_parallel)` (which `train()` does not take, as
    the reference's does not) and the expert stacks sharded over `experts`
    (the reference's `moe-ep-data` where "data": each expert's d_ff over
    'model', the tokens exchanged over 'data'): the weights of `cfg` drawn
    from the seed whole on each card and sharded, MESH_STEPS steps on the
    global batch's rows; the launches a step checked, the exchanges
    counted.  Returns the losses, launches, step times and each card's
    peak; with `probe`, also each card's peak over one more forward and
    backward of the last batch alone (no AdamW), from what the steps left
    allocated."""
    from repro_torch.collectives import bruck_all_to_all
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_model
    from repro_torch.optim import adamw_init

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(tc.mesh_shape, tc.mesh_axes, dev)
    lay = train_mod.layout(tc, train_mod.current_world(), mesh)
    if experts != "model":
        lay = dataclasses.replace(lay, split=dataclasses.replace(
            lay.split, experts=mesh.get_group(experts)))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    shard_model(model, mesh, moe_expert_axis=experts)
    params = sum(p.numel() for p in model.parameters())
    opt = adamw_init(list(model.parameters()))
    step_fn = train_mod.make_train_step(tc, lay, mesh, seq_parallel=seq_parallel)
    data = SyntheticLM(cfg.vocab_size, tc.seq_len, seed=tc.seed)
    per = tc.batch_size // lay.rows.size
    rows = slice(lay.rows.rank * per, (lay.rows.rank + 1) * per)
    reset_launches()
    bruck_all_to_all.calls = 0
    losses, step_s = [], []
    for step in range(tc.steps):
        batch = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in data.global_batch(step, tc.batch_size, 1).items()}
        t0 = time.perf_counter()
        opt, metrics, _ = step_fn(model, opt, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(round(time.perf_counter() - t0, 4))
    launches, designs, calls = read_launches(), read_designs(), bruck_all_to_all.calls
    check_tensor_core_launches(label)
    per_step = check_train_launches(label, cfg.layer_kinds, len(losses), launches, designs)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    out = {"losses": losses, "launches": launches, "per_step": per_step, "step_s": step_s,
           "ep_a2a": calls, "peaks": rank_memory(dev), "params": params}
    if probe:
        from repro_torch.launch.shardings import activation_rules
        from repro_torch.models.sharding import activation_sharding

        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize(dev)
        out["held"] = rank_memory_of(torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        with activation_sharding(mesh, activation_rules(mesh, seq_parallel), lay.split):
            loss_fn(cfg, model, batch)[0].backward()
        torch.cuda.synchronize(dev)
        out["fwd_bwd_peaks"] = rank_memory(dev)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_whole(arch: str, shape: tuple, n: int, dev, say, reference: float | None) -> dict:
    """`arch` whole at full width (bf16, full remat, 8 x 512) trained
    MESH_STEPS steps on a `shape` mesh with sequence parallelism: its first
    loss against one card's forward `loss_fn` (`reference`, rank 0's from
    `tp_whole`) at TP_LOSS_RTOL; the launches of B1-B5' a step."""
    import torch.distributed as dist

    tc = mesh_tc(arch, shape, TP_AXES)
    cfg = full_config(tc)
    run = sp_mesh_train(tc, cfg, f"train {arch} whole on {shape}, sequence parallel", dev)
    if dist.get_rank() == 0:
        diff = abs(run["losses"][0] - reference) / abs(reference)
        say(f"mesh train {arch} whole ({cfg.num_layers} layers) on {shape} with sequence "
            f"parallelism, bf16, remat full, 8 x 512: losses {run['losses']}, steps "
            f"{run['step_s']} s, launches a step {run['per_step']}; first loss against one "
            f"card's forward loss_fn {reference}: relative difference {diff:.3e} (rtol "
            f"{TP_LOSS_RTOL[arch]}); peak memory a card "
            f"{[round(x / 2**30, 3) for x in run['peaks']]} GiB")
        run["diff"] = diff
        if diff > TP_LOSS_RTOL[arch]:
            raise AssertionError(f"{arch} on {shape} with sequence parallelism: first loss "
                                 f"{run['losses'][0]} against one card's {reference}")
    return run


def moe_sp_and_ep(n: int, dev, say) -> dict:
    """qwen3-moe at full width cut to 1 layer on (2, 2), MESH_STEPS gspmd
    steps (bf16, full remat, 8 x 512), with sequence parallelism and, apart,
    with its expert stacks sharded over 'data' and each expert's d_ff over
    'model' (`moe-ep-data`); the parent holds both runs' losses to phase
    8's unsharded ones at LOSS_RTOL."""
    out = {}
    for name, seq, experts in (("sp", True, "model"), ("ep_data", False, "data")):
        tc = mesh_tc(MOE_ARCH, (2, 2), TP_AXES)
        cfg = dataclasses.replace(full_config(tc), num_layers=1)
        out[name] = sp_mesh_train(tc, cfg, f"train {MOE_ARCH} 1 layer on (2, 2), {name}", dev,
                                  seq_parallel=seq, experts=experts)
        say(f"mesh train {MOE_ARCH} 1 layer on (2, 2), "
            f"{'sequence parallel' if seq else 'moe-ep-data (experts over data, d_ff over model)'}"
            f": losses {out[name]['losses']}, steps {out[name]['step_s']} s, launches a step "
            f"{out[name]['per_step']}, exchanges {out[name]['ep_a2a']}, peak memory a card "
            f"{[round(x / 2**30, 3) for x in out[name]['peaks']]} GiB")
    return out


def combine_layout(cfg, model, mesh, batch: int, max_seq: int, variant: str, dev):
    """The dry run's sharded serving layout with real tensors on `dev`: its
    serving `TokenSplit` and the caches as `cache_shardings` lays them
    out (`launch.dryrun._split`, `_shard_caches`)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeConfig, init_caches

    shape = ShapeConfig("combine", max_seq, batch, "decode")
    _, split = dryrun._split(shape, mesh, {variant})
    caches = dryrun._shard_caches(init_caches(cfg, split.rows, max_seq, dev), cfg, mesh,
                                  batch, variant == "kv-seq-sharded")
    return split, caches


def combine_greedy(cfg, model, mesh, split, caches, prompts, steps: int, counter=None):
    """Prefill and `steps` - 1 greedy decode steps inside the sharded serving
    layout: (each step's logits (B, V) f32 on the host, the ids (B, steps));
    `counter` (a `dryrun.CollectiveCounter`) counts the first decode step's
    collectives."""
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models.model import greedy, last_logits
    from repro_torch.models.sharding import activation_sharding

    out, tokens, mode = [], prompts, "prefill"
    # no_grad, not inference_mode: DTensor's redistribute refuses inference tensors
    with torch.no_grad(), activation_sharding(mesh, activation_rules(mesh), split,
                                              sharded_caches=True):
        for i in range(steps):
            ctx = counter if counter is not None and i == 1 else contextlib.nullcontext()
            with ctx:
                res = forward(cfg, model, {"tokens": tokens}, caches=caches, mode=mode,
                              logits_whole=False)
                local = last_logits(cfg, model, res.logits, whole=False)
                ids = greedy(cfg, model, local)
            out.append(last_logits(cfg, model, res.logits).float().cpu())
            tokens, mode = ids[:, None], "decode"
    return out, torch.stack([x.argmax(-1) for x in out], 1)


def combine_reckoning(cfg, batch: int, max_seq: int, variant: str, tp: int) -> dict:
    """The bytes one decode step moves over 'model' for the sequence-sharded
    cache leaves: gathered (every such leaf whole, the all-gather's result)
    against combined (two all-reduces a layer: each (row, head)'s max, and
    its sum and unnormalised P V or latent, f32)."""
    gathered = combined = 0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "local") and variant == "kv-seq-sharded" \
                and cfg.num_kv_heads % tp:
            s_cache = min(max_seq, cfg.window) if kind == "local" else max_seq
            if s_cache % tp == 0:
                gathered += 2 * batch * cfg.num_kv_heads * s_cache * cfg.head_dim * 2
                combined += batch * cfg.num_heads * (cfg.head_dim + 2) * 4
        elif kind == "mla" and max_seq % tp == 0:
            m = cfg.mla
            gathered += batch * max_seq * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
            combined += batch * cfg.num_heads * (m.kv_lora_rank + 2) * 4
    return {"gathered": gathered, "combined": combined}


def combine_paths(n: int, dev, say) -> dict:
    """Decode through the dry run's sharded-cache serving layout on (1, n),
    real tensors: recurrentgemma-9b under `kv-seq-sharded` (one KV head;
    its local layers' ring buffer) and minicpm3-4b's latent cache in the
    baseline layout, where each rank attends over its own slots and the
    peers' partial softmaxes are combined.  In f32 at COMBINE_CASES' depth
    (COMBINE_PROMPT + COMBINE_STEPS, a cache of 100), the logits of every
    step against rank 0's unsharded run within COMBINE_TOL, the same ids;
    in bf16 whole, phase 7's prompts of 512 (the cache rounded up to
    COMBINE_SERVE_SEQ slots, so it divides), COMBINE_SERVE_TOKENS ids beside
    the first of phase 7's; the
    bytes a decode step sends over 'model' (counted) beside the gather's
    and the combine's reckoning."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import init_sharded

    rank = dist.get_rank()
    mesh = make_mesh((1, n), TP_AXES, dev)
    one_card = json.loads(Path(os.environ["CHIP_SMOKE_SERVED"]).read_text())
    out = {}
    for arch, (layers, variant, cuts) in COMBINE_CASES.items():
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers, dtype="float32", **cuts)
        prompts = tp_prompts(cfg, COMBINE_PROMPT)
        max_seq = COMBINE_PROMPT + COMBINE_STEPS
        want = None
        if rank == 0:
            model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            with torch.inference_mode():
                want = tp_greedy(cfg, model, prompts, COMBINE_STEPS, max_seq, dev)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh,
                             fsdp=False)
        split, caches = combine_layout(cfg, model, mesh, 4, max_seq, variant, dev)
        sharded = sorted(f"{i}.{k}" for i, c in enumerate(caches)
                         for k in ("k", "v", "c_kv", "k_rope")
                         if hasattr(c["mix"].get(k), "device_mesh"))
        got = combine_greedy(cfg, model, mesh, split, caches, prompts.to(dev), COMBINE_STEPS)
        del model, caches
        gc.collect()
        torch.cuda.empty_cache()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, got[1].tolist())
        if rank == 0:
            errs = [max_err(g, w, COMBINE_TOL, COMBINE_TOL)
                    for g, w in zip(got[0], want[0], strict=True)]
            same = torch.equal(got[1], want[1]) and all(x == every[0] for x in every)
            say(f"mesh combine {arch} ({layers} layers, f32, {variant}"
                f"{', ' + str(cuts) if cuts else ''}, 4 x ({COMBINE_PROMPT} + "
                f"{COMBINE_STEPS}), a cache of {max_seq}) on (1, {n}), sequence-sharded cache "
                f"leaves {sharded}: logits max|err| prefill and decode steps against one card "
                f"{[round(e, 8) for e, _ in errs]} (tol {COMBINE_TOL} + {COMBINE_TOL}|want|), "
                f"ids equal to one card's and on every rank {same}")
            if not sharded or not all(ok for _, ok in errs) or not same:
                raise AssertionError(f"{arch}: decode through the sharded caches differs "
                                     f"from one card")
            out[f"{arch} f32"] = {"errs": [e for e, _ in errs], "sharded": sharded}

        # whole, bf16, phase 7's requests
        cfg = configs.get(arch)
        model = init_sharded(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, mesh,
                             fsdp=False)
        prompts = tp_prompts(cfg, 512)
        split, caches = combine_layout(cfg, model, mesh, 4, COMBINE_SERVE_SEQ, variant, dev)
        counter = dryrun.CollectiveCounter()
        t0 = time.perf_counter()
        _, ids = combine_greedy(cfg, model, mesh, split, caches, prompts.to(dev),
                                COMBINE_SERVE_TOKENS, counter)
        wall = time.perf_counter() - t0
        del model, caches
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            mine = {i: one_card[arch][str(i)][:COMBINE_SERVE_TOKENS] for i in range(4)}
            agree = sum(a == b for i in range(4) for a, b in
                        zip(ids[i].tolist(), mine[i], strict=True)) / (4 * COMBINE_SERVE_TOKENS)
            sent = counter.result()
            reckoned = combine_reckoning(cfg, 4, COMBINE_SERVE_SEQ, variant, n)
            say(f"mesh combine {arch} whole ({cfg.num_layers} layers, bf16, {variant}) on (1, "
                f"{n}), 4 x (512 + {COMBINE_SERVE_TOKENS}), a cache of {COMBINE_SERVE_SEQ}: "
                f"{wall:.1f} s; ids agree with phase 7's one card's first {COMBINE_SERVE_TOKENS} "
                f"at {agree * 100:.1f} % of positions (not gated); a "
                f"decode step's collectives over the mesh (counted, result bytes) {sent}; the "
                f"sequence-sharded leaves' bytes a step, gathered {reckoned['gathered']} "
                f"against combined {reckoned['combined']} (reckoned)")
            out[arch] = {"agreement": agree, "sent": sent, "reckoned": reckoned, "wall_s": wall}
    return out


def pipeline_paths(n: int, dev, say) -> dict:
    """Check 4 on the cards: the reference's tanh stages (S = 4, D = 16,
    batch 8, 4 microbatches) equal sequential at PIPE_TOL; then stablelm-3b's
    32 blocks at full width as 4 stages of 8, 8 x 512 in 4 microbatches,
    forward, equal to rank 0's sequential run of the same blocks on the same
    microbatches bit for bit, with B1 8 times a microbatch a stage."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import run_pipeline
    from repro_torch.models.model import _embed_inputs, apply_block

    rank = dist.get_rank()
    mesh = make_mesh((n,), ("pod",), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = 16
    stage_w = torch.randn((n, d, d), generator=gen, device=dev) / d ** 0.5
    x = torch.randn((8, d), generator=gen, device=dev)

    def tanh_stage(w, h):
        return torch.tanh(h @ w)

    out = run_pipeline(mesh, "pod", tanh_stage, stage_w, x, PIPE_MICRO)
    seq = x
    for w in stage_w:
        seq = tanh_stage(w, seq)
    tanh_err = (out - seq).abs().max().item()
    say(f"pipeline tanh stages (S = {n}, D = {d}, batch 8, {PIPE_MICRO} microbatches, f32): "
        f"max|pipeline - sequential| {tanh_err:.3e} (atol {PIPE_TOL})")
    if not tanh_err <= PIPE_TOL:
        raise AssertionError(f"pipeline differs from sequential: {tanh_err}")

    arch = "stablelm-3b"
    cfg = configs.get(arch)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    per = cfg.num_layers // n
    stages = [list(model.blocks[s * per:(s + 1) * per]) for s in range(n)]
    b, _, seq_len = TRAIN_CASE[:3]
    tokens = SyntheticLM(cfg.vocab_size, seq_len, seed=SEED).global_batch(0, b, 1)["tokens"]

    def blocks_stage(blocks, h):
        positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device).expand(
            h.shape[0], h.shape[1])
        for blk in blocks:
            h = apply_block(cfg, blk, blk.kind, h, positions)[0]
        return h

    with torch.inference_mode():
        h, _ = _embed_inputs(cfg, model, {"tokens": torch.from_numpy(tokens).to(dev)})
        torch.cuda.synchronize(dev)
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        piped = run_pipeline(mesh, "pod", blocks_stage, stages, h, PIPE_MICRO)
        torch.cuda.synchronize(dev)
        dist.barrier()
        pipe_wall = time.perf_counter() - t0
        launches = read_launches()
        check_tensor_core_launches(f"pipeline {arch} stage {rank}")
        want = {k: 0 for k in launches} | {"flash_attention_fwd": per * PIPE_MICRO}
        if launches != want:
            raise AssertionError(f"pipeline {arch} stage {rank}: launches {launches}, "
                                 f"expected {want}")
        out = {"launches": launches, "pipe_wall_s": pipe_wall}
        if rank == 0:
            reset_launches()
            t0 = time.perf_counter()
            outs = []
            for hm in h.reshape(PIPE_MICRO, -1, *h.shape[1:]):
                for blocks in stages:
                    hm = blocks_stage(blocks, hm)
                outs.append(hm)
            sequential = torch.cat(outs)
            torch.cuda.synchronize(dev)
            seq_wall = time.perf_counter() - t0
            same = torch.equal(piped, sequential)
            bubble = (n - 1) / (PIPE_MICRO + n - 1)
            say(f"pipeline {arch} ({cfg.num_layers} blocks as {n} stages of {per}, full width, "
                f"bf16, forward, 8 x 512 in {PIPE_MICRO} microbatches of "
                f"{b // PIPE_MICRO}): output bit-identical to one card's sequential run of the "
                f"same microbatches {same}; B1 launches a stage {launches['flash_attention_fwd']} "
                f"({per} a microbatch); wall pipeline {pipe_wall:.4f} s, sequential "
                f"{seq_wall:.4f} s (host clock); bubble (S - 1)/(M + S - 1) = "
                f"{n - 1}/{PIPE_MICRO + n - 1} = {bubble:.4f}")
            if not same:
                raise AssertionError(f"pipeline {arch} differs from the sequential run")
            out |= {"seq_wall_s": seq_wall, "bubble": bubble, "tanh_err": tanh_err}
    del model, stages
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_path(n: int, dev, say) -> dict:
    """Check 5 on the cards: stablelm-3b at full width cut to ELASTIC_LAYERS,
    2 gspmd steps on (4,) ('data',) saving a checkpoint, steps 3-4 resumed on
    (2, 2) ("data", "model") (launches counted), against 4 straight steps on
    (4,) at ELASTIC_RTOL."""
    import torch.distributed as dist

    arch = "stablelm-3b"
    flat, square = ((n,), ("data",)), ((2, 2), ("data", "model"))
    cfg = dataclasses.replace(full_config(mesh_tc(arch)), num_layers=ELASTIC_LAYERS)

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)

    holder = [tempfile.mkdtemp(prefix="chip_smoke_elastic_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(holder, src=0)
    d = holder[0]
    try:
        straight = mesh_train(mesh_tc(arch, *flat, steps=4), fresh(), f"elastic {arch} straight",
                              dev)
        first = mesh_train(mesh_tc(arch, *flat, checkpoint_dir=d, checkpoint_every=2),
                           fresh(), f"elastic {arch} first", dev)
        ckpt_bytes = dir_bytes(os.path.join(d, "step_00000002"))
        resumed = mesh_train(mesh_tc(arch, *square, steps=4, checkpoint_dir=d), fresh(),
                             f"elastic {arch} resumed", dev)
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(d, ignore_errors=True)
    lines = first["lines"] + resumed["lines"]
    seconds = [float(x) for x in re.findall(r"\(([0-9.]+) s\)", "\n".join(lines))]
    got, want = first["losses"] + resumed["losses"], straight["losses"]
    diff = [abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)]
    say(f"elastic {arch} ({ELASTIC_LAYERS} layers, bf16, gspmd, 8 x 512): 2 steps on {flat[0]} "
        f"saved, steps 3-4 resumed on {square[0]}: losses {got} against the straight "
        f"{flat[0]} run's {want}, relative differences {diff} (rtol {ELASTIC_RTOL}); "
        f"checkpoint {ckpt_bytes} bytes, save / restore seconds {seconds}; resumed launches a "
        f"step {resumed['per_step']}")
    if len(got) != 4 or max(diff) > ELASTIC_RTOL:
        raise AssertionError(f"elastic restart {got} against {want}")
    for run in (straight, first, resumed):
        del run["model"], run["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": got, "straight": want, "diff": diff, "checkpoint_bytes": ckpt_bytes,
            "seconds": seconds, "launches": resumed["launches"]}


def mesh_paths(n: int, dev, say) -> dict:
    """Phase 9's mesh paths (four cards), tensor parallel over 'model' where
    the mesh has it: the TP parity of serving, command-r-plus-104b served
    whole on (1, 4) and trained at 4 layers (with and without sequence
    parallelism), the TP parity of training, check 3 at 1 and 4 layers and
    the EP exchange, recurrentgemma-9b whole on (2, 2) and rwkv6-3b whole on
    (1, 4) (each with and without sequence parallelism; the training parity
    also holds the sequence-parallel step and the vocab-parallel loss to
    TP's and the gathered logits'), qwen3-moe with sequence parallelism
    and under `moe-ep-data`, decode combined over sequence-sharded caches,
    check 4, check 5."""
    paths = {"tp_serve_parity": lambda: tp_serve_parity(n, dev, say),
             "tp_serve": lambda: tp_serve_whole(n, dev, say),
             "command_r_train": lambda: tp_command_r_train(n, dev, say),
             "tp_train_parity": lambda: tp_train_parity(n, dev, say),
             "moe_1": lambda: mesh_moe(n, dev, say, 1), "moe_4": lambda: mesh_moe(n, dev, say, 4),
             "ep_exchange": lambda: time_ep_exchange(dev, say),
             "griffin": lambda: tp_whole("recurrentgemma-9b", (2, 2), n, dev, say),
             "griffin_sp": lambda: sp_whole("recurrentgemma-9b", (2, 2), n, dev, say,
                                            out["griffin"].get("reference_loss")),
             "rwkv": lambda: tp_whole("rwkv6-3b", (1, n), n, dev, say),
             "rwkv_sp": lambda: sp_whole("rwkv6-3b", (1, n), n, dev, say,
                                         out["rwkv"].get("reference_loss")),
             "moe_sp_ep": lambda: moe_sp_and_ep(n, dev, say),
             "combine": lambda: combine_paths(n, dev, say),
             "pipeline": lambda: pipeline_paths(n, dev, say),
             "elastic": lambda: elastic_path(n, dev, say)}
    out = {}
    for name, fn in paths.items():
        t0 = time.perf_counter()
        out[name] = fn()
        say(f"mesh path {name}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --- multi-card phase ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sample_card_memory(stop: threading.Event, peaks: dict) -> None:
    """Every half second until `stop`: each card's memory in use as
    nvidia-smi reads it (every process on the card), the peak kept in
    `peaks` (card index -> MiB)."""
    while not stop.wait(0.5):
        out = subprocess.run(["nvidia-smi", "--query-gpu=index,memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        for line in out.strip().splitlines():
            card, used = (int(x) for x in line.split(","))
            peaks[card] = max(peaks.get(card, 0), used)


def multi_card(n: int, main_losses: list[float], moe_losses: list[float]) -> dict:
    """Start n ranks of this script (--rank) with torchrun and return rank 0's
    results.  Their first training losses must match the main path's: the
    global batch does not depend on the world size; so must qwen3-moe's on
    (2, 2) at 1 layer those of phase 8's unsharded run (`moe_losses`).  Card
    0 holds this process beside rank 0: each card's peak use is sampled."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), __file__, "--rank"]
    print(f"multi-card: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved on card 0 as the ranks start")
    stop, peaks = threading.Event(), {}
    sampler = threading.Thread(target=sample_card_memory, args=(stop, peaks))
    sampler.start()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=1800)[0]
    finally:
        if proc.poll() is None:  # stop torchrun and every rank it started
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        stop.set()
        sampler.join()
    print(out, end="")
    print(f"multi-card: {n} ranks ran {time.perf_counter() - t0:.1f} s; each card's peak "
          f"memory in use (nvidia-smi, every process, sampled every 0.5 s): "
          f"{[peaks.get(i) for i in range(n)]} MiB")
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
    if "mesh" in res:
        got = res["mesh"]["moe_1"]["losses"]
        diff = [abs(a - b) / abs(b) for a, b in zip(got, moe_losses, strict=True)]
        print(f"mesh train {MOE_ARCH} 1 layer on (2, 2) against phase 8's unsharded run on one "
              f"card: losses {got} against {moe_losses}, relative differences {diff} (the "
              f"first step's is the forward's alone; rtol {LOSS_RTOL})")
        if max(diff) > LOSS_RTOL:
            raise AssertionError(f"{MOE_ARCH} on (2, 2) differs from one card: {diff}")
        for name, run in res["mesh"]["moe_sp_ep"].items():
            diff = [abs(a - b) / abs(b) for a, b in zip(run["losses"], moe_losses, strict=True)]
            print(f"mesh train {MOE_ARCH} 1 layer on (2, 2), {name}, against phase 8's "
                  f"unsharded run on one card: losses {run['losses']} against {moe_losses}, "
                  f"relative differences {diff} (rtol {LOSS_RTOL})")
            if max(diff) > LOSS_RTOL:
                raise AssertionError(f"{MOE_ARCH} on (2, 2), {name}, differs from one card: "
                                     f"{diff}")
    return res


def multi_card_phase(count: int, served_ids: dict, main_losses: list[float],
                     moe_losses: list[float]) -> dict:
    """Phase 9 on `count` cards: `multi_card` on up to four, given phase 7's
    ids (`served_ids`, written to a file named by CHIP_SMOKE_SERVED for the
    ranks) and phase 8's losses; nothing on one card."""
    if count < 2:
        print(f"multi-card phase: not run ({count} device)")
        return {}
    gc.collect()
    torch.cuda.empty_cache()  # rank 0 shares this card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_served_") as d:
        served = Path(d) / "ids.json"
        served.write_text(json.dumps(served_ids))
        os.environ["CHIP_SMOKE_SERVED"] = str(served)
        return multi_card(min(4, count), main_losses, moe_losses)


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
        if n == 4:
            out["mesh"] = mesh_paths(n, dev, say)
        else:
            say(f"mesh paths (check 3, recurrentgemma-9b whole, check 4, check 5): not run "
                f"({n} ranks; they need 4)")
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
    cfg = dataclasses.replace(full_config(tc), num_layers=RESTART_LAYERS)

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


# --- phase 12: the example scripts' twins ---------------------------------------------

EXAMPLES = Path(__file__).resolve().parent / "examples"
TWIN_SERVE_ARCHS = ("gemma3-4b", "minicpm3-4b", "rwkv6-3b")   # its three cache families
TWIN_NEW_TOKENS = 16       # examples/serve_decode.py's default
TWIN_TRAIN_STEPS = 300     # examples/train_lm.py's default
TWIN_CPU_STEPS = 3         # the train twin's steps run again on the CPU
TWIN_LOSS_RTOL = 2e-4      # the twin's first losses against JAX's (tests/test_torch_examples.py)
# the explorer's batched event simulation (the verify skill's surface 3)
TWIN_EXPLORER_ARGS = ("--collective", "a2a", "--n", "96", "--delta-us", "1000",
                      "--fabric", "ocs-sim", "--overlap", "0.75")


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def attention_layers(cfg) -> int:
    return sum(k in ATTENTION_KINDS for k in cfg.layer_kinds)


def card_weights(init):
    """`init_params` as the twins call it, but drawn on the card whatever
    the device: a run of a twin on the CPU then starts from the weights of
    its run on the card (the two devices' generators draw different
    numbers from one seed)."""
    def draw(cfg, gen, dev):
        seed = gen.initial_seed()
        return init(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda").to(dev)
    return draw


def twin_paths() -> dict:
    """The twins of examples/*.py on the card, as a user runs them (the
    scaled-down configs, f32), each run again with `--device cpu` from the
    same weights (`card_weights`) and held to it: serve_decode for the three
    cache families (B1 at gemma3-4b's and minicpm3-4b's prefills and full
    forwards, the latter's q/k head of 24 padded to 32; B5 in rwkv6-3b's
    prefill, decode steps and full forward), its greedy agreement printed
    and its ids equal to the CPU's; train_lm at its 300 steps (B1, B2, B3)
    and its own gate, its first TWIN_CPU_STEPS losses within TWIN_LOSS_RTOL
    of the CPU's; the schedule explorer's ocs-sim (B6), whose lines equal
    the NumPy run's and whose every B6 call is held to the plain version
    and the largest timed.  Returns each path's launches and B6's numbers."""
    import io
    from unittest import mock

    out = {}
    serve = load_example("torch_serve_decode")
    for arch in TWIN_SERVE_ARCHS:
        cfg = configs.get(arch).scaled_down()
        reset_launches()
        t0 = time.perf_counter()
        gen, agree = serve.main(["--arch", arch],
                                say=lambda m, a=arch: print(f"twin serve {a}: {m}"))
        launches = read_launches()
        # prefill, the decode steps, and the full forward of the greedy check
        pre, dec = expected_serve_launches(cfg, TWIN_NEW_TOKENS)
        want = {k: 2 * pre[k] + dec[k] for k in pre}
        if launches != want:
            raise AssertionError(f"twin serve {arch}: launches {launches}, expected {want}")
        secs = time.perf_counter() - t0
        with mock.patch.object(serve, "init_params", card_weights(serve.init_params)):
            gen_cpu, agree_cpu = serve.main(["--arch", arch, "--device", "cpu"],
                                            say=lambda m: None)
        if read_launches() != launches:
            raise AssertionError(f"twin serve {arch}: the CPU run launched a kernel")
        print(f"twin serve {arch} (scaled down, f32, {tuple(gen.shape)} generated): greedy "
              f"agreement with full forward {agree * 100:.1f}%, launches {launches}, "
              f"{secs:.1f} s; --device cpu from the same weights: ids equal "
              f"{torch.equal(gen, gen_cpu)}, agreement {agree_cpu * 100:.1f}%")
        if not torch.equal(gen, gen_cpu):
            raise AssertionError(f"twin serve {arch}: the card's ids {gen.tolist()} differ "
                                 f"from the CPU's {gen_cpu.tolist()}")
        out[f"serve {arch}"] = launches
    train_twin = load_example("torch_train_lm")
    reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()  # a line a step: its first and last lines are printed
    try:
        with contextlib.redirect_stdout(buf):
            losses = train_twin.main([])  # its gate: losses[-1] < 0.8 ln(V), else SystemExit
    finally:
        lines = buf.getvalue().splitlines()
        print("\n".join(f"twin train: {ln}" for ln in lines[:3] + ["..."] + lines[-5:]))
    launches = read_launches()
    secs = time.perf_counter() - t0
    a = attention_layers(configs.get("stablelm-3b").scaled_down()) * TWIN_TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * a, "flash_attention_bwd_dkv": a,
            "flash_attention_bwd_dq": a}     # full remat runs B1 twice a step
    if {k: launches[k] for k in want} != want or len(losses) != TWIN_TRAIN_STEPS:
        raise AssertionError(f"twin train: launches {launches}, expected {want}")
    # the first steps again on the CPU, from the card run's weights (train()
    # draws them from the seed on the run's device); so few steps fail the
    # twin's gate, as in tests/test_torch_examples.py
    seen = {}

    def on_cpu(tc, progress, device):
        model = card_weights(init_params)(train_mod.model_config(tc),
                                          torch.Generator().manual_seed(tc.seed), device)
        seen["losses"] = train_mod.train(tc, progress=progress, device=device,
                                         model=model)[2]
        return None, None, seen["losses"]

    with mock.patch.object(train_twin, "train", on_cpu), \
            contextlib.redirect_stdout(io.StringIO()):
        try:
            train_twin.main(["--steps", str(TWIN_CPU_STEPS), "--device", "cpu"])
        except SystemExit:
            pass
    cpu_losses = seen["losses"]
    diff = [abs(x - y) / abs(y) for x, y in zip(losses, cpu_losses, strict=False)]
    print(f"twin train stablelm-3b (scaled down, f32): {len(losses)} steps in {secs:.1f} s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}; --device cpu "
          f"from the same weights, {TWIN_CPU_STEPS} steps: losses {cpu_losses} against the "
          f"card's {losses[:TWIN_CPU_STEPS]}, relative differences {diff} (rtol "
          f"{TWIN_LOSS_RTOL})")
    if len(cpu_losses) != TWIN_CPU_STEPS or max(diff) > TWIN_LOSS_RTOL:
        raise AssertionError("twin train: the card's first losses differ from the CPU's")
    out["train stablelm-3b"] = launches
    explorer = load_example("torch_schedule_explorer")
    from repro_torch.core import batchsim_torch

    lines, calls = {}, []
    b6 = batchsim_torch.fabric_playback

    def recorded(*args, **kw):  # B6 as batch_run calls it, its inputs kept
        calls.append((tuple(t.clone() for t in args), kw))
        return b6(*args, **kw)

    for device in ("cuda", "cpu"):
        before = playback_kernel.fabric_playback.launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(batchsim_torch, "fabric_playback", recorded):
            explorer.main([*TWIN_EXPLORER_ARGS, "--device", device])
        lines[device] = buf.getvalue()
        out[f"explorer {device}"] = {"fabric_playback":
                                     playback_kernel.fabric_playback.launches - before}
    print(lines["cuda"], end="")
    if out["explorer cuda"]["fabric_playback"] == 0 or out["explorer cpu"]["fabric_playback"] \
            or len(calls) != out["explorer cuda"]["fabric_playback"]:
        raise AssertionError(f"twin explorer: B6 launches {out}, calls {len(calls)}")
    if lines["cuda"] != lines["cpu"]:
        raise AssertionError("twin explorer: the card's lines differ from NumPy's")
    print(f"twin explorer {' '.join(TWIN_EXPLORER_ARGS)}: B6 launched "
          f"{out['explorer cuda']['fabric_playback']} times, lines equal to the NumPy run's")
    for i, (args, kw) in enumerate(calls):
        check_playback_call(args, kw, f"twin explorer call {i}")
    args, kw = max(calls, key=lambda c: c[0][2].sum().item())
    hops = args[2].cpu().numpy()
    out["explorer"] = {"shape": [int(hops.shape[0]), int(hops.shape[1]), kw["n"], kw["C"]],
                       "times": time_playback(args, kw, hops, sm_clock_hz(),
                                              "twin explorer, its most hops")}
    return out


# --- phase 13: the dry run on a fake world ----------------------------------------------

# one cell per mode (and a MoE variant) through the CLI: no device memory moves
DRYRUN_CELLS = (("stablelm-3b", "train_4k", "pod", "baseline"),
                ("whisper-base", "prefill_32k", "multipod", "baseline"),
                ("qwen3-moe-235b-a22b", "decode_32k", "pod", "moe-ep-data"),
                ("rwkv6-3b", "long_500k", "multipod", "baseline"),
                ("stablelm-3b", "train_4k", "pod", "seq-parallel"),
                ("command-r-plus-104b", "decode_32k", "pod", "kv-seq-sharded"))


def dryrun_cells() -> None:
    """`python -m repro_torch.launch.dryrun` for DRYRUN_CELLS, in process,
    under this CUDA build: each cell is OK, and `torch.cuda.memory_allocated`
    does not move."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    if dist.is_initialized():  # phase 8's one-rank mesh; the dry run makes its own world
        dist.destroy_process_group()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out:
        for arch, shape, mesh, variant in DRYRUN_CELLS:
            t0 = time.perf_counter()
            dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--variant",
                         variant, "--out", out])
            tag = f"{arch}__{shape}__{mesh}" + ("" if variant == "baseline" else f"__{variant}")
            res = json.loads(Path(out, f"{tag}.json").read_text())
            if "error" in res:
                raise AssertionError(f"dry run {tag}: {res['error']}")
            print(f"dry run {tag}: {time.perf_counter() - t0:.1f} s, calibrated flops "
                  f"{res['calibrated']['flops']:.4g}, memory {res['memory']}")
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before:
        raise AssertionError(f"the dry run moved the card's memory: {before} -> "
                             f"{torch.cuda.memory_allocated()} bytes")
    print(f"dry run: {len(DRYRUN_CELLS)} cells traced, card memory allocated "
          f"{before} bytes before and after")


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
                              QWEN_CASE, QWEN_TRAIN_CASE, *RANK_CASES, *NEW_CASES,
                              *SLICE15_CASES)}
    fwd_times.update({case: time_flash(case, torch.float32) for case in F32_FWD_CASES})
    bwd_times = {case: time_bwd(case) for case in TRAIN_BWD_CASES}
    bwd_times.update({case: time_bwd(case, torch.float32) for case in F32_BWD_CASES})
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
    serve_launches, served_ids = {}, {}
    for arch in SERVE_ARCHS:  # one model at a time: each is freed before the next
        for prompt_len, new_tokens in SERVE_LENGTHS.get(arch, ((SERVE_PROMPT.get(arch, 512),
                                                                 32),)):
            key = arch if arch not in SERVE_LENGTHS else f"{arch} {prompt_len}+{new_tokens}"
            repeats = GRAPH_REPEATS if arch in GRAPH_REPEAT_ARCHS and not any(
                k.startswith(arch) for k in served_ids) else 1
            serve_launches[key], served_ids[key] = serve_path(arch, prompt_len, new_tokens,
                                                              repeats)
            gc.collect()
            torch.cuda.empty_cache()
    phase("8 train (main path)")
    train_launches, train_losses, dots_launches = {}, {}, {}
    for arch, num_layers in TRAIN_ARCHS:  # one model at a time
        run = train_path(arch, num_layers)
        train_launches[arch], train_losses[arch] = run[:2]
        gc.collect()
        torch.cuda.empty_cache()
        if arch in DOTS_ARCHS:  # the same run under remat "dots", from the same seed
            dots = train_path(arch, num_layers, policy="dots")
            dots_against_full(arch, run, dots)
            dots_launches[arch] = dots[0]
            gc.collect()
            torch.cuda.empty_cache()
    moe_runs = moe_mesh_path()
    gc.collect()
    torch.cuda.empty_cache()
    phase("9 multi-card")
    multi = multi_card_phase(count, served_ids, train_losses["stablelm-3b"],
                             moe_runs["unsharded"]["losses"])
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
    phase("12 example twins")
    twins = twin_paths()
    gc.collect()
    torch.cuda.empty_cache()
    phase("13 dry run on a fake world")
    dryrun_cells()
    phase(None)

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

    def with_other(times: dict, *cases, errs=None, name=None) -> dict:
        """`times` with the numbers of a path's other shapes under other_shapes."""
        return dict(times, other_shapes=[
            {"shape": list(case), "max_abs_err": (errs[case] if name is None
                                                  else errs[(name, case)]),
             **(fwd_times[case] if name is None else bwd_times[case][name])}
            for case in cases])

    gemma_long, gemma_wrap = (serve_launches[f"gemma3-4b {n}+{m}"]
                              for n, m in SERVE_LENGTHS["gemma3-4b"])
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
        # phase 8: minicpm3-4b (MLA at D = 96) and gemma3-4b (local layers
        # masked by their window, the global ones' numbers under other_shapes)
        ("train minicpm3-4b", "flash_attention_fwd", MLA_TRAIN_CASE,
         train_launches["minicpm3-4b"], fwd_errs[MLA_TRAIN_CASE], fwd_times[MLA_TRAIN_CASE]),
        *(("train minicpm3-4b", name, MLA_BWD_CASE, train_launches["minicpm3-4b"],
           bwd_errs[(name, MLA_BWD_CASE)], bwd_times[MLA_BWD_CASE][name])
          for name in bwd_names),
        ("train gemma3-4b", "flash_attention_fwd", GEMMA_TRAIN_LOCAL,
         train_launches["gemma3-4b"], fwd_errs[GEMMA_TRAIN_LOCAL],
         with_other(fwd_times[GEMMA_TRAIN_LOCAL], GEMMA_TRAIN_GLOBAL, errs=fwd_errs)),
        *(("train gemma3-4b", name, GEMMA_BWD_LOCAL, train_launches["gemma3-4b"],
           bwd_errs[(name, GEMMA_BWD_LOCAL)],
           with_other(bwd_times[GEMMA_BWD_LOCAL][name], GEMMA_BWD_GLOBAL, errs=bwd_errs,
                      name=name))
          for name in bwd_names),
        # phase 8: stablelm-3b and rwkv6-3b trained again under remat "dots"
        ("train stablelm-3b (remat dots)", "flash_attention_fwd", TRAIN_FWD_CASE,
         dots_launches["stablelm-3b"], fwd_errs[TRAIN_FWD_CASE], fwd_times[TRAIN_FWD_CASE]),
        *(("train stablelm-3b (remat dots)", name, TRAIN_CASE, dots_launches["stablelm-3b"],
           bwd_errs[(name, TRAIN_CASE)], bwd_times[TRAIN_CASE][name]) for name in bwd_names),
        *(("train rwkv6-3b (remat dots)", name, WKV_TRAIN, dots_launches["rwkv6-3b"],
           rec_errs[(name, WKV_TRAIN)], rec_times[(name, WKV_TRAIN)])
          for name in ("wkv6_fwd", "wkv6_bwd")),
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
        ("serve gemma3-4b prefill 1536", "flash_attention_fwd", GEMMA_SERVE_LOCAL,
         gemma_long["prefill"], fwd_errs[GEMMA_SERVE_LOCAL],
         with_other(fwd_times[GEMMA_SERVE_LOCAL], GEMMA_SERVE_GLOBAL, errs=fwd_errs)),
        ("serve gemma3-4b prefill 1000", "flash_attention_fwd", GEMMA_WRAP_CASE,
         gemma_wrap["prefill"], fwd_errs[GEMMA_WRAP_CASE], fwd_times[GEMMA_WRAP_CASE]),
        ("serve command-r-plus-104b prefill", "flash_attention_fwd", COMMAND_R_CASE,
         serve_launches["command-r-plus-104b"]["prefill"], fwd_errs[COMMAND_R_CASE],
         fwd_times[COMMAND_R_CASE]),
        ("serve arctic-480b prefill", "flash_attention_fwd", ARCTIC_CASE,
         serve_launches["arctic-480b"]["prefill"], fwd_errs[ARCTIC_CASE],
         fwd_times[ARCTIC_CASE]),
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
        # phase 8: qwen3-moe trained unsharded and on a (1, 1) mesh
        *((f"train {MOE_ARCH} {run}", name, case, moe_runs[run]["launches"], err, times)
          for run in ("unsharded", "mesh (1, 1)")
          for name, case, err, times in (
              ("flash_attention_fwd", QWEN_TRAIN_CASE, fwd_errs[QWEN_TRAIN_CASE],
               fwd_times[QWEN_TRAIN_CASE]),
              *((name, QWEN_BWD_CASE, bwd_errs[(name, QWEN_BWD_CASE)],
                 bwd_times[QWEN_BWD_CASE][name]) for name in bwd_names))),
    ]
    # phase 12: the twins (f32), each at its path's shapes
    twin_fwd = {"serve gemma3-4b": (TWIN_GEMMA_LOCAL, TWIN_GEMMA_GLOBAL,
                                    TWIN_GEMMA_FULL_LOCAL, TWIN_GEMMA_FULL_GLOBAL),
                "serve minicpm3-4b": (TWIN_MLA_CASE, TWIN_MLA_FULL),
                "train stablelm-3b": (TWIN_TRAIN_FWD,)}
    for path, (case, *others) in twin_fwd.items():
        entries.append((f"twin {path}", "flash_attention_fwd", case, twins[path],
                        fwd_errs[case], with_other(fwd_times[case], *others, errs=fwd_errs)))
    entries += [("twin train stablelm-3b", name, TWIN_TRAIN_BWD, twins["train stablelm-3b"],
                 bwd_errs[(name, TWIN_TRAIN_BWD)], bwd_times[TWIN_TRAIN_BWD][name])
                for name in bwd_names]
    entries.append(("twin serve rwkv6-3b", "wkv6_fwd", TWIN_WKV_STEP, twins["serve rwkv6-3b"],
                    rec_errs[("wkv6_fwd", TWIN_WKV_STEP)],
                    dict(rec_times[("wkv6_fwd", TWIN_WKV_STEP)], other_shapes=[
                        {"shape": list(case), "max_abs_err": rec_errs[("wkv6_fwd", case)],
                         **rec_times[("wkv6_fwd", case)]}
                        for case in (TWIN_WKV_PREFILL, TWIN_WKV_FULL)])))
    entries.append((f"twin explorer {' '.join(TWIN_EXPLORER_ARGS)}", "fabric_playback",
                    tuple(twins["explorer"]["shape"]), twins["explorer cuda"], 0.0,
                    twins["explorer"]["times"]))
    # phase 9's mesh paths (four cards): rank 0's launches, at a rank's shapes
    mesh = multi.get("mesh", {})
    rank_paths = {
        "moe_1": (f"mesh train {MOE_ARCH} 1 layer (2, 2), rank 0", QWEN_RANK_CASE, QWEN_RANK_BWD),
        "moe_4": (f"mesh train {MOE_ARCH} 4 layers (2, 2), rank 0", QWEN_RANK_CASE,
                  QWEN_RANK_BWD),
        "griffin": ("mesh train recurrentgemma-9b whole (2, 2), rank 0", GRIFFIN_RANK_CASE,
                    GRIFFIN_RANK_BWD),
        "rwkv": ("mesh train rwkv6-3b whole (1, 4), rank 0", None, None),
        "elastic": ("mesh train stablelm-3b resumed on (2, 2), rank 0", STABLELM_TP_CASE,
                    STABLELM_TP_BWD),
        "pipeline": ("pipeline stablelm-3b, stage 0", STABLELM_RANK_CASE, None),
        "tp_serve": ("mesh serve command-r-plus-104b whole (1, 4) prefill, rank 0",
                     COMMAND_R_TP_CASE, None),
        "tp_serve_parity": ("mesh serve parity command-r-plus-104b 2 layers f32 (1, 4), rank 0",
                            TP_SERVE_F32_CASE, None)}
    for key, (path, fwd_case, bwd_case) in rank_paths.items():
        if key not in mesh:
            continue
        launches = mesh[key]["launches"]
        if fwd_case is not None:
            entries.append((path, "flash_attention_fwd", fwd_case, launches,
                            fwd_errs[fwd_case], fwd_times[fwd_case]))
        if bwd_case is not None:
            entries += [(path, name, bwd_case, launches, bwd_errs[(name, bwd_case)],
                         bwd_times[bwd_case][name]) for name in bwd_names]
        if key == "griffin":
            entries += [(path, name, LRU_RANK, launches, rec_errs[(name, LRU_RANK)],
                         rec_times[(name, LRU_RANK)]) for name in ("rg_lru_fwd", "rg_lru_bwd")]
        if key == "rwkv":
            entries += [(path, name, WKV_RANK, launches, rec_errs[(name, WKV_RANK)],
                         rec_times[(name, WKV_RANK)]) for name in ("wkv6_fwd", "wkv6_bwd")]
    for shape, fwd_case, bwd_case in (("2x2", COMMAND_R_TRAIN_22, COMMAND_R_BWD_22),
                                      ("1x4", COMMAND_R_TRAIN_14, COMMAND_R_BWD_14)):
        if shape not in mesh.get("command_r_train", {}):
            continue
        path = f"mesh train command-r-plus-104b 4 layers ({shape.replace('x', ', ')}), rank 0"
        launches = mesh["command_r_train"][shape]["launches"]
        entries.append((path, "flash_attention_fwd", fwd_case, launches, fwd_errs[fwd_case],
                        fwd_times[fwd_case]))
        entries += [(path, name, bwd_case, launches, bwd_errs[(name, bwd_case)],
                     bwd_times[bwd_case][name]) for name in bwd_names]
    for shape, fwd_case, bwd_case in (("2x2", TP_TRAIN_F32_22, TP_TRAIN_F32_BWD[0]),
                                      ("1x4", TP_TRAIN_F32_14, TP_TRAIN_F32_BWD[1])):
        if shape not in mesh.get("tp_train_parity", {}):
            continue
        path = f"mesh train parity stablelm-3b 2 layers f32 ({shape.replace('x', ', ')}), rank 0"
        launches = mesh["tp_train_parity"][shape]["launches"]
        entries.append((path, "flash_attention_fwd", fwd_case, launches, fwd_errs[fwd_case],
                        fwd_times[fwd_case]))
        entries += [(path, name, bwd_case, launches, bwd_errs[(name, bwd_case)],
                     bwd_times[bwd_case][name]) for name in bwd_names]
    print(f"launches: serve {serve_launches}, train {train_launches}, twins "
          f"{ {k: v for k, v in twins.items() if k != 'explorer'} }")
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

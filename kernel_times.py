#!/usr/bin/env python3
"""Times the port's kernel wrappers of one source tree, two ways, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_times.py                        # this checkout's src/
    python3 kernel_times.py --src OTHER/src        # e.g. a parent commit from git archive
    python3 kernel_times.py --edit ko_pv           # a copy with one stage knocked out
    python3 kernel_times.py --host                 # also the B4 / B5 decode wrappers' host parts
    python3 kernel_times.py --only wkv6_fwd        # one kernel's shapes only
    python3 kernel_times.py --only fabric_playback --src build/parent/src --edit ko_parent_gather
    python3 kernel_times.py --only fabric_playback --plan 32768   # and the planner's latency
    python3 kernel_times.py --edit ko_v_tail --check  # B1's bf16 checks on a faulty copy

It times, with `chip_smoke.py`'s inputs and timing function, the
flash-attention forward (B1) at the training shape and the two serving
prefill shapes, the dK/dV (B2) and dQ (B3) backward at the training shape,
the RG-LRU (B4) and WKV-6 (B5) recurrences at the serving prefill and
decode shapes, their backward (B4', B5') at the training shapes, each in
the dtype its path gives it, the fabric playback (B6) at chip_smoke's phase
10 shapes (the three tiers and the planner's a2a sets at n = 1536 and
32768; in a tree whose wrapper takes a layout, also on one cluster size up
where the plan's trains sit in registers on fewer than 16 CTAs), and the
card's launch floor (`torch.cuda._sleep(0)`, always timed):
  ms         CUDA events around 20 queued calls; the wrapper's host work
             counts wherever it outlasts the kernel (chip_smoke's `ms`);
  device_ms  the same with the card held by a sleep kernel while the calls
             are queued: device time only (chip_smoke's `device_ms`).
Each is the median of three rounds, taken in turns (B6 where a lane walks
more than 4096 hops: one call after one warm-up, not 20).  `--src` names
the `src` directory whose `repro_torch` is timed, so that two trees are
timed by the same code on the same card in one run.  `--edit` applies
named edits (EDITS) to a copy of that tree's kernel sources under
build/kernel_times/ and times the copy: knock-outs of one stage of B1's bf16
tensor-core loop, of one pass or one stage of a pass of B5's two-pass
design, of the y store or the chain of B4's ring, of one pass or one part
of B5''s chunked design (bf16), or of the da/db store or the copies of
B4''s ring, of the parent B6's hop barrier or its gather of another
port's comp, of the redesigned B6's wait for pushed bytes, its DSMEM push
or its maxima (their outputs are wrong; only their times mean something), and tuning variants (B4's ring with one stage: load,
wait, compute; B5''s intra-chunk products with their decayed operand in
one TF32 part, not two; B6's one-CTA lanes through the cluster exchange,
its max as an integer compare), and faults for
`--check` (ko_v_tail: V read as zeros in B1's partial last key tile).  `--check` runs, in place
of the timings, `chip_smoke.py`'s check of B1 against its plain version at
each of its bf16 cases, and prints each check's verdict: a fault that
leaves every check passing is one the script cannot see. Prints one line
per kernel and shape, the card's name and power limit, and a JSON line
{"src", "edits", "card", "times", "host_us"}. `--host` also times, on the
host clock, the parts of the WKV-6 and RG-LRU wrappers' work in a decode
call (T = 1, bf16 and f32, chip_smoke's inputs): each whole call, the
import and lookup of the library, each wrapper's checks where its tree has
them apart (RG-LRU's `_check`), each pair of output allocations, the two
ways to read the current stream, and each ctypes call that launches (the
WKV-6 one, in a tree that sets it on every launch, also calls
cudaFuncSetAttribute; the RG-LRU one never does). Each part is the median
of 7 rounds of 200 calls, in microseconds a call. Exits non-zero without a
CUDA card.  `--plan N` also times, on the host clock, a fresh planner's
ocs-sim plan of a2a, rs and ag at n = N with the tree's B6 (chip_smoke's
request: m = 4 MiB, delta = 1 ms), printed and in the JSON line's "plan_s".
"""
from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FWD = "kernels/csrc/flash_attention_fwd.cu"
BWD = "kernels/csrc/flash_attention_bwd.cu"
WKV = "kernels/csrc/wkv6.cu"
WKV_BWD = "kernels/csrc/wkv6_bwd.cu"
LRU = "kernels/csrc/rg_lru.cu"
B6 = "kernels/csrc/fabric_playback.cu"
# name -> [(file under repro_torch/, text, replacement)]; each text must
# appear exactly once.  ko_* take one stage out of B1's bf16 loop and keep
# the operands it reads in use, so the compiler keeps the rest.
EDITS = {
    "ko_load": [(FWD, "if (t + 1 < n_tiles) {  // the next tile's copy flies",
                 "if (false) {  // knocked out: no copy after the first tile")],
    "ko_qk": [(FWD, "tc::mma_bf16(s[2 * np], a, b[0], b[1]);\n"
                    "          tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);",
               "s[2 * np][0] += __uint_as_float(a[0] ^ b[0] ^ b[1]);\n"
               "          s[2 * np + 1][0] += __uint_as_float(a[1] ^ b[2] ^ b[3]);")],
    "ko_mask": [(FWD, "if (cut) {", "if (false) {")],
    "ko_exp": [(FWD, "const float p = tc::ex2((s[j][e] - m[e / 2]) * kLog2e);",
                "const float p = (s[j][e] - m[e / 2]) * kLog2e;")],
    "ko_pv": [(FWD, "tc::mma_bf16(acc[2 * dp], a, b[0], b[1]);\n"
                    "          tc::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);",
               "acc[2 * dp][0] += __uint_as_float(a[0] ^ a[2] ^ b[0] ^ b[1]);\n"
               "          acc[2 * dp + 1][0] += __uint_as_float(a[1] ^ a[3] ^ b[2] ^ b[3]);")],
    # a fault for --check: B1's bf16 loop reads V as zeros in a partial last
    # key tile (the rows from sk rounded down to the tile)
    "ko_v_tail": [(FWD, "tc::load_tile_async<D, kBlockK, kThreads>(v_s, v_g, kt_begin, sk);",
                   "tc::load_tile_async<D, kBlockK, kThreads>(v_s, v_g, kt_begin, "
                   "sk / kBlockK * kBlockK);"),
                  (FWD, "v_g, kt + kBlockK,\n                                                sk);",
                   "v_g, kt + kBlockK,\n                                                "
                   "sk / kBlockK * kBlockK);")],
    # tuning: no minimum of CTAs an SM (up to 255 registers) at D <= 80
    "no_min_ctas": [(FWD, "__launch_bounds__(kThreads, D <= 80 ? 3 : 1)",
                     "__launch_bounds__(kThreads, 1)")],
    # tuning: 32-key tiles at every head dim
    "k32": [(FWD, "return D > 128 ? 32 : 64;", "return 32;")],
    # tuning: B3's tensor-core variant asks for the largest shared-memory carveout
    "dq_carveout": [(BWD, "reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel<D>), "
                          "static_cast<int>(smem));",
                     "reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel<D>), "
                     "static_cast<int>(smem), true);")],
    # B5's two-pass design with one pass left out (the other's time alone)
    "ko_wkv_output": [(WKV, "  wkv6_output_kernel<<<", "  if (false) wkv6_output_kernel<<<")],
    "ko_wkv_state": [(WKV, "  wkv6_state_kernel<<<", "  if (false) wkv6_state_kernel<<<")],
    # ... and one stage of the state pass left out: the next chunk's copy, the
    # scan of c, the exps of k~, the update of S
    "ko_state_load": [(WKV, "    if (c + 1 < n_chunks) load(c + 1);",
                       "    if (false) load(c + 1);")],
    "ko_state_scan": [(WKV, "    chunk_cumsum<kStateThreads / kMaxDim>(lb, kMaxDim, ks, kCStride, "
                            "kLog2e, totals);\n", "")],
    "ko_state_exp": [(WKV, "__bfloat162float(kb[i]) * tc::ex2(clast[d] - *at)",
                      "__bfloat162float(kb[i]) * (clast[d] - *at)")],
    "ko_state_update": [(WKV, "        tc::mma_tf32(S[n], big, b0, b1);\n"
                              "        tc::mma_tf32(S[n], small, b0, b1);",
                         "        S[n][0] += __uint_as_float(big[0] ^ small[1] ^ b0 ^ b1);")],
    # ... or of the output pass: the scan of c, A left of the diagonal
    # sub-block, the per-element pairs of the diagonal quarters
    "ko_out_scan": [(WKV, "  chunk_cumsum<kThreads / kMaxDim>(ls, kBStride, cs + kCStride, "
                          "kCStride, kLog2e, totals);\n", "")],
    "ko_out_offdiag": [(WKV, "  if (warp > 0) {\n    const float* cref = cs + s * kCStride;",
                        "  if (false) {\n    const float* cref = cs + s * kCStride;")],
    "ko_out_diag": [(WKV, "  for (int p = lane; p < 2 * 28; p += 32) {",
                     "  for (int p = lane; p < 0; p += 32) {")],
    # B4's ring with one part left out: the y store, the chain (h = b, so
    # the loads of a still land but feed nothing), the copies (the chain
    # reads what shared memory holds); and with one stage, so that each
    # stage's copy is waited for before its chain runs
    "ko_lru_store": [(LRU, "        if (d0 + col < d) {", "        if (false) {")],
    "ko_lru_chain": [(LRU, "h = step(to_float(ra[i * kLanes + lane]), h, "
                           "to_float(rb[i * kLanes + lane]));",
                      "h = to_float(rb[i * kLanes + lane]);")],
    "ko_lru_load": [(LRU, "    if (s < groups) load_stage", "    if (false) load_stage"),
                    (LRU, "    if (next < groups) {", "    if (false) {")],
    "lru_one_stage": [(LRU, "constexpr int kStages = 4;", "constexpr int kStages = 1;")],
    # tuning of B4's ring: stages, steps a stage, bytes of a CTA's row,
    # streaming y stores, y stored from the chain (4 bytes a thread a step)
    "lru_stages8": [(LRU, "constexpr int kStages = 4;", "constexpr int kStages = 8;")],
    "lru_steps32": [(LRU, "constexpr int kSteps = 16;", "constexpr int kSteps = 32;")],
    "lru_steps8": [(LRU, "constexpr int kSteps = 16;", "constexpr int kSteps = 8;")],
    "lru_row256": [(LRU, "constexpr int kRowBytes = 128;", "constexpr int kRowBytes = 256;")],
    "lru_stcs": [(LRU, "*reinterpret_cast<uint4*>(y + (row0 + t0 + i) * d + d0 + col) =\n"
                       "              *reinterpret_cast<const uint4*>(sy + i * kLanes + col);",
                  "__stcs(reinterpret_cast<uint4*>(y + (row0 + t0 + i) * d + d0 + col),\n"
                  "              *reinterpret_cast<const uint4*>(sy + i * kLanes + col));")],
    # B5''s chunked design (bf16) with one pass left out, or one part of its
    # gradient pass: the diagonal quarters per element, A past the sub-block
    # (dv); and with the intra-chunk products' decayed operand in one TF32
    # part, not two (outputs outside the bound: times only)
    "ko_bwd_state": [(WKV_BWD, "  wkv6_bwd_state_kernel<<<", "  if (false) wkv6_bwd_state_kernel<<<")],
    "ko_bwd_grad": [(WKV_BWD, "  wkv6_bwd_grad_kernel<<<", "  if (false) wkv6_bwd_grad_kernel<<<")],
    "ko_bwd_diag": [(WKV_BWD, "  for (int m = 0; m < 7; ++m) {", "  for (int m = 0; m < 0; ++m) {")],
    "ko_bwd_dv_off": [(WKV_BWD, "  if (warp + 1 < kWarps) {  // A^T[j, t] for t past the block",
                       "  if (false) {  // A^T[j, t] for t past the block")],
    "bwd_one_tf32": [(WKV_BWD, "  tc::mma_tf32(c, a, __float_as_uint(b0 - __uint_as_float(bb0)),\n"
                                "               __float_as_uint(b1 - __uint_as_float(bb1)));\n", "")],
    # ... and parts of either pass: the gradient-state pass's G_out writes and
    # its update of G
    "ko_bwd_state_store": [(WKV_BWD, "kMaxDim * kMaxDim;\n#pragma unroll\n    for (int n = 0; n < 4; ++n) {",
                            "kMaxDim * kMaxDim;\n#pragma unroll\n    for (int n = 0; n < 0; ++n) {")],
    "ko_bwd_state_update": [(WKV_BWD, "        tc::mma_tf32(G[n], big, b0, b1);\n        tc::mma_tf32(G[n], small, b0, b1);",
                             "        G[n][0] += __uint_as_float(big[0] ^ small[1] ^ b0 ^ b1);")],
    # ... more parts of the gradient pass: the products with G_out (dk's and
    # dv's first terms), the off-diagonal products of dr and dk, the sums of
    # dlog_w over later steps; of the gradient-state pass: its exps of r e^{c},
    # its copies
    "ko_bwd_dki": [(WKV_BWD, "tc::mma_tf32(dki[n], a, __float_as_uint(grow[e]), __float_as_uint(grow[e + 4]));",
                    "dki[n][0] += __uint_as_float(a[0] ^ __float_as_uint(grow[e]));")],
    "ko_bwd_dv_inter": [(WKV_BWD, "tc::mma_tf32(dvv[n], a, __float_as_uint(gsm[d * kFStride + 8 * n + g]),",
                         "dvv[n][0] += __uint_as_float(a[0] ^ __float_as_uint(gsm[d * kFStride + 8 * n + g])); if (false) tc::mma_tf32(dvv[n], a, 0u,")],
    "ko_bwd_dr_off": [(WKV_BWD, "    for (int kk = 0; kk < 2 * warp; ++kk) {  // warp-uniform",
                       "    for (int kk = 0; kk < 0; ++kk) {  // warp-uniform")],
    "ko_bwd_dk_off": [(WKV_BWD, "    for (int kk = 2 * warp + 2; kk < 8; ++kk) {  // warp-uniform; A = dA^T",
                       "    for (int kk = 8; kk < 8; ++kk) {  // warp-uniform; A = dA^T")],
    "ko_bwd_sums": [(WKV_BWD, "    for (int i = kSub - 1; i >= 0; --i) {\n      float2* at",
                     "    for (int i = -1; i >= 0; --i) {\n      float2* at")],
    "ko_bwd_state_exp": [(WKV_BWD, "*at = t < len ? __bfloat162float(rb[i]) * tc::ex2(*at) : 0.f;",
                          "*at = t < len ? __bfloat162float(rb[i]) * (*at) : 0.f;")],
    "ko_bwd_state_load": [(WKV_BWD, "    if (c > 0) load(c - 1);", "    if (false) load(c - 1);")],
    # B4''s ring with its da/db store stage or its copies left out
    "ko_lru_bwd_store": [(LRU, "        if (col < d - d0) {", "        if (false) {")],
    "ko_lru_bwd_load": [(LRU, "    if (k < groups) load(k);", "    if (false) load(k);"),
                        (LRU, "    if (k + kStages - 1 < groups) load(k + kStages - 1);",
                         "    if (false) load(k + kStages - 1);")],
    "lru_direct_y": [(LRU, "        if constexpr (kVec) {\n"
                           "          sy[i * kLanes + lane] = from_float<T>(h);\n"
                           "        } else if (live) {", "        if (live) {"),
                     (LRU, "if constexpr (kVec) {  // the stage's y rows",
                      "if constexpr (false) {  // the stage's y rows")],
}


# B6: in the first design (one CTA a lane; `--src` a tree of it), its barrier a hop
# or its gather of C values of another port's comp through L2 (the arrival
# becomes the port's own clock); in the redesign, the wait for a buffer's
# pushed bytes or the DSMEM push (every push into the CTA's own buffer and
# mbarrier at the same offset).  The redesign's relaxed cluster barrier, the
# guard against pushing into a buffer still read, has no knock-out: without
# it a push can land in the mbarrier's next phase, and the lane never ends.
EDITS.update({
    "ko_parent_barrier": [(B6, "      __syncthreads();\n      par ^= 1;", "      par ^= 1;")],
    "ko_parent_gather": [(B6, "const double a = __dadd_rn(prev[c * static_cast<int64_t>(n) + q], "
                              "alpha_h);", "const double a = __dadd_rn(f, alpha_h);")],
    "ko_data_wait": [(B6, '"@!ready bra WAIT;\\n\\t}"', '"}"')],
    "ko_dsmem_push": [(B6, "const uint32_t rank = target >> 16;",
                       'uint32_t rank;\n    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));')],
    # ... or a chunk's max (f = arrival + tau)
    "ko_pb_max": [(B6, "f[i] = __dadd_rn(later(f[i], a[i][c]), st.tau);",
                   "f[i] = __dadd_rn(a[i][c], st.tau);")],
    # tuning: a lane of one CTA through the cluster exchange (st.async,
    # mbarriers), not plain stores and __syncthreads
    "pb_k1_exchange": [(B6, "local(K == 1)", "local(false)")],
    # tuning: the max as a compare of the bit patterns as integers (the same
    # order for non-negative doubles), off the FP64 pipe
    "pb_int_max": [(B6, "__device__ __forceinline__ double later(double f, double a) { return a > f ? a : f; }",
                    "__device__ __forceinline__ double later(double f, double a) {\n"
                    "  const long long x = __double_as_longlong(f), y = __double_as_longlong(a);\n"
                    "  return __longlong_as_double(y > x ? y : x);\n}")],
})


def edited_copy(src: Path, names: list[str]) -> Path:
    """A copy of `src`'s repro_torch with the edits `names` applied, under
    build/kernel_times/<names>/ (its kernels build into build/kernel_times/build)."""
    dest = ROOT / "build" / "kernel_times" / "+".join(names)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dest / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in names:
        for rel, old, new in EDITS[name]:
            path = dest / "repro_torch" / rel
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"edit {name}: {old!r} is in {rel} {text.count(old)} times")
            path.write_text(text.replace(old, new))
    return dest


def cases(cs) -> list:
    """(name, shape, call) of every kernel and shape timed but B6, with
    chip_smoke's inputs."""
    out = []
    for case in (cs.TRAIN_FWD_CASE, cs.SERVE_CASE, cs.GRIFFIN_CASE):
        d, causal, window = case[5], case[6], case[7]
        q, k, v = (t.to(torch.bfloat16) for t in cs.flash_inputs(case))
        out.append(("flash_attention_fwd", case,
                    lambda q=q, k=k, v=v, d=d, causal=causal, window=window:
                    cs.flash_kernel.flash_attention_fwd_lse(q, k, v, scale=d ** -0.5,
                                                            causal=causal, window=window)))
    q, k, v, do, _, lse, dvec = cs.bwd_inputs(cs.TRAIN_CASE, torch.bfloat16)
    kw = {"scale": cs.TRAIN_CASE[4] ** -0.5, "causal": cs.TRAIN_CASE[5],
          "window": cs.TRAIN_CASE[6]}
    for fn in (cs.flash_bwd.flash_attention_bwd_dkv, cs.flash_bwd.flash_attention_bwd_dq):
        out.append((fn.__name__, cs.TRAIN_CASE, lambda fn=fn: fn(q, k, v, do, lse, dvec, **kw)))
    for case in (cs.LRU_PREFILL, cs.LRU_DECODE):
        a, x, h0 = cs.lru_inputs(case, cs.PATH_DTYPE["rg_lru_fwd"])
        out.append(("rg_lru_fwd", case,
                    lambda a=a, x=x, h0=h0: cs.lru_kernel.rg_lru_fwd(a, x, h0)))
    # PyTorch's elementwise kernel moving B4's prefill bytes (read a and b,
    # write one array like y): the rate this card gives that traffic
    a, x, _ = cs.lru_inputs(cs.LRU_PREFILL, cs.PATH_DTYPE["rg_lru_fwd"])
    out.append(("rg_lru_fwd bytes by torch.add", cs.LRU_PREFILL,
                lambda a=a, x=x: torch.add(a, x)))
    for case in (cs.WKV_PREFILL, cs.WKV_DECODE):
        args = cs.wkv_inputs(case, cs.PATH_DTYPE["wkv6_fwd"])
        out.append(("wkv6_fwd", case, lambda args=args: cs.wkv_kernel.wkv6_fwd(*args)))
    # the backward at the training shapes, from the forward's y and workspace
    a, x, h0, gy, gh = cs.lru_bwd_inputs(cs.LRU_TRAIN, cs.PATH_DTYPE["rg_lru_bwd"])
    y, _ = cs.lru_kernel.rg_lru_fwd(a, x, h0)
    out.append(("rg_lru_bwd", cs.LRU_TRAIN,
                lambda a=a, x=x, h0=h0, y=y, gy=gy, gh=gh:
                cs.lru_kernel.rg_lru_bwd(a, x, h0, y, gy, gh)))
    r, k, v, lw, u, s0, gy, gs = cs.wkv_bwd_inputs(cs.WKV_TRAIN, cs.PATH_DTYPE["wkv6_bwd"])
    ws = cs.wkv_kernel.wkv6_fwd(r, k, v, lw, u, s0)[2]
    out.append(("wkv6_bwd", cs.WKV_TRAIN,
                lambda args=(r, k, v, lw, u, s0, gy, gs, ws): cs.wkv_kernel.wkv6_bwd(*args)))
    return out


def playback_cases(cs) -> list:
    """(name, shape, call, calls a timing) of B6 at chip_smoke's phase 10
    shapes, with its inputs; one cluster size up beside the plan's own where
    the tree's wrapper takes a layout (`launch_plan`, `_plan`)."""
    cm = cs.PAPER_DEFAULT.replace(delta=cs.SIM_DELTA)
    sets = [(f"tier {name}", cs.tier_lanes(n, cs.SIM_M, B, cap), C)
            for name, (n, B, C, cap) in cs.SIM_TIERS.items()]
    for n in cs.PLAN_NS:
        sets.append((f"plan a2a n={n}", [
            cs.batchsim.BatchLane(schedule=sched, m_bytes=cs.SIM_M)
            for _, sched in cs.schedules.candidate_schedules("a2a", n, cs.SIM_M, cm)],
            cs.Planner().sim_chunks))
    fn = cs.playback_kernel.fabric_playback
    launch_plan = getattr(cs.playback_kernel, "launch_plan", None)  # none in the parent
    out = []
    for label, lanes, C in sets:
        args, kw, hops = cs.playback_inputs(lanes, cm, C)
        iters = 1 if int(hops.sum(axis=1).max()) > 4096 else 10
        shape = (label, *hops.shape, kw["n"], C)
        out.append(("fabric_playback", shape, lambda args=args, kw=kw: fn(*args, **kw), iters))
        plan = launch_plan(kw["n"], C) if launch_plan else None
        if plan and plan.comp == "registers" and plan.cluster < cs.playback_kernel.MAX_CLUSTER:
            up = launch_plan(kw["n"], C, cluster=min(cs.playback_kernel.MAX_CLUSTER,
                                                     2 * plan.cluster))
            out.append((f"fabric_playback on {up.cluster} CTAs (plan {plan.cluster})", shape,
                        lambda args=args, kw=kw, up=up: fn(*args, **kw, _plan=up), iters))
    return out


# the card's launch floor: an empty kernel, timed as the kernels are
LAUNCH_FLOOR = ("launch_floor", (), lambda: torch.cuda._sleep(0), 20)


def host_parts(cs) -> dict:
    """Microseconds a call of the parts of the WKV-6 and RG-LRU wrappers'
    host work in a decode call, on the host clock (see the module
    docstring)."""
    r, k, v, log_w, u, s0 = cs.wkv_inputs(cs.WKV_DECODE, torch.bfloat16)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    lib = cs._build.library()
    y = torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device)
    s_last = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = [x.data_ptr() for x in (r, k, v, log_w, u, s0, y, s_last)]
    # a library with the two-pass design takes a workspace pointer after s_last
    workspace = [None] if len(lib.wkv6_fwd.argtypes) == 16 else []
    a, x, h0 = cs.lru_inputs(cs.LRU_DECODE, torch.float32)
    ya, ha = torch.empty_like(a), torch.empty_like(h0)
    ba, _, da = a.shape
    # rg_lru_fwd's C signature, (a, b, h0, y, h_last, batch, steps, d,
    # is_bf16, stream), is the same in every tree so far; a tree with another
    # has its ctypes call left out rather than called wrongly
    lru_args = (a.data_ptr(), x.data_ptr(), h0.data_ptr(), ya.data_ptr(), ha.data_ptr(),
                ba, 1, da, 0, stream)
    lru_launch = len(lib.rg_lru_fwd.argtypes) == len(lru_args)
    lru_check = getattr(cs.lru_kernel, "_check", None)  # apart in this tree?

    def library():
        return importlib.import_module("repro_torch.kernels._build").library()

    parts = {
        "wkv6 wrapper call": lambda: cs.wkv_kernel.wkv6_fwd(r, k, v, log_w, u, s0),
        "import + library()": library,
        "wkv6 two torch.empty": lambda: (
            torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device),
            torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)),
        "current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(
            r.device).cuda_stream,
        "_cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(r.device.index),
        "wkv6 ctypes call (launch)": lambda: lib.wkv6_fwd(
            *ptrs, *workspace, b * h, h, t, dk, dv, 1, stream),
        "rg_lru wrapper call": lambda: cs.lru_kernel.rg_lru_fwd(a, x, h0),
        **({"rg_lru checks (_check)": lambda: lru_check(a, x, h0)} if lru_check else {}),
        "rg_lru two torch.empty": lambda: (torch.empty_like(a),
                                           torch.empty((ba, da), dtype=torch.float32,
                                                       device=a.device)),
        **({"rg_lru ctypes call (launch, no attribute)": lambda: lib.rg_lru_fwd(*lru_args)}
           if lru_launch else {}),
    }
    rounds = {name: [] for name in parts}
    for _ in range(7):
        for name, fn in parts.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(200):
                fn()
            rounds[name].append((time.perf_counter_ns() - t0) / 200 / 1e3)
            torch.cuda.synchronize()
    out = {name: sorted(v)[3] for name, v in rounds.items()}
    for name, us in out.items():
        print(f"decode host part {name}: {us:.3f} us a call "
              f"(rounds {min(rounds[name]):.3f}-{max(rounds[name]):.3f})")
    return out


def plan_seconds(cs, n: int) -> dict:
    """Seconds of `Planner(sim_backend="torch").plan` of a fresh planner, on
    the host clock, for a2a, rs and ag at n with chip_smoke's ocs-sim request
    (m = 4 MiB, delta = 1 ms), each once after one warm-up plan at n = 48."""
    cm = cs.PAPER_DEFAULT.replace(delta=cs.SIM_DELTA)

    def request(kind, size):
        return cs.PlanRequest(kind=kind, n=size, m_bytes=cs.SIM_M, cost_model=cm,
                              fabric=cs.FabricKind.OCS_SIM)
    cs.Planner(sim_backend="torch").plan(request("a2a", 48))
    out = {}
    for kind in cs.SIM_KINDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.Planner(sim_backend="torch").plan(request(kind, n))
        out[kind] = time.perf_counter() - t0
        print(f"plan ocs-sim {kind} n={n}: {out[kind]:.4f} s (host clock, fresh planner)")
    return out


def check(cs, src: Path, edits: list[str]) -> None:
    """chip_smoke's check of B1 against its plain version at each of its bf16
    cases, on this tree: prints each check's verdict and a JSON line
    {"src", "edits", "card", "checks"}; exits 0 whatever the verdicts."""
    checks = []
    for case, dtype in cs.flash_check_cases():
        if dtype != torch.bfloat16:
            continue
        err, verdicts, line = cs.check_flash(case, dtype)
        print(f"{line}; verdicts {verdicts}")
        checks.append({"shape": list(case), "max_abs_err": err, "verdicts": verdicts})
    card = cs.nvidia_smi()
    print(card)
    print(json.dumps({"src": str(src), "edits": edits, "card": card, "checks": checks}))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src directory whose repro_torch is timed")
    parser.add_argument("--edit", action="append", default=[], choices=sorted(EDITS),
                        help="an edit of the kernel sources (repeatable)")
    parser.add_argument("--only", action="append", default=[],
                        help="time only this kernel (repeatable; default: all)")
    parser.add_argument("--host", action="store_true",
                        help="also time the parts of the decode wrappers' host work")
    parser.add_argument("--check", action="store_true",
                        help="run chip_smoke's bf16 checks of B1 instead of timing")
    parser.add_argument("--plan", type=int, action="append", default=[],
                        help="also time the planner's ocs-sim plans at this n (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device; this script runs only on the card")
    src = Path(args.src).resolve()
    if args.edit:
        src = edited_copy(src, args.edit)
    # The timed tree's package goes into sys.modules first: chip_smoke's
    # `repro_torch` imports then resolve inside it, not in this checkout.
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401
    import chip_smoke as cs

    if Path(repro_torch.__file__).resolve().parent != src / "repro_torch":
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.library()
    if args.check:
        check(cs, src, args.edit)
        return
    runs: dict = {}
    timed = []
    if not args.only or set(args.only) - {"fabric_playback"}:
        timed += [(*case, 20) for case in cases(cs)
                  if not args.only or case[0].split()[0] in args.only]
    if not args.only or "fabric_playback" in args.only:
        timed += playback_cases(cs)
    timed.append(LAUNCH_FLOOR)
    for _ in range(3):
        for i, (_, _, fn, iters) in enumerate(timed):
            for key, hold in (("ms", False), ("device_ms", True)):
                runs.setdefault((i, key), []).append(
                    cs.time_ms(fn, iters=iters, warmup=1 if iters == 1 else 3, hold=hold))
    times = []
    for i, (name, shape, _, _) in enumerate(timed):
        entry = {"name": name, "shape": list(shape),
                 **{key: sorted(runs[(i, key)])[1] for key in ("ms", "device_ms")}}
        times.append(entry)
        print(f"{name} {shape}: ms {entry['ms']:.4f} device_ms {entry['device_ms']:.4f}")
    host_us = host_parts(cs) if args.host else None
    plans = {n: plan_seconds(cs, n) for n in args.plan}
    card = cs.nvidia_smi()
    print(card)
    print(json.dumps({"src": str(src), "edits": args.edit, "card": card, "times": times,
                      "host_us": host_us, "plan_s": plans}))


if __name__ == "__main__":
    main()

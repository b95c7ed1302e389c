#!/usr/bin/env python3
"""Times the port's kernel wrappers of one source tree, two ways, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_times.py                        # this checkout's src/
    python3 kernel_times.py --src OTHER/src        # e.g. a parent commit from git archive
    python3 kernel_times.py --edit ko_pv           # a copy with one stage knocked out

It times, with `chip_smoke.py`'s inputs and timing function, the
flash-attention forward (B1) at the training shape and the two serving
prefill shapes, the dK/dV (B2) and dQ (B3) backward at the training shape,
and the RG-LRU (B4) and WKV-6 (B5) recurrences at the serving prefill and
decode shapes, each in the dtype its path gives it:
  ms         CUDA events around 20 queued calls; the wrapper's host work
             counts wherever it outlasts the kernel (chip_smoke's `ms`);
  device_ms  the same with the card held by a sleep kernel while the calls
             are queued: device time only (chip_smoke's `device_ms`).
Each is the median of three rounds, taken in turns.  `--src` names
the `src` directory whose `repro_torch` is timed, so that two trees are
timed by the same code on the same card in one run.  `--edit` applies
named edits (EDITS) to a copy of that tree's kernel sources under
build/kernel_times/ and times the copy: knock-outs of one stage of B1's
bf16 tensor-core loop (their outputs are wrong; only their times mean
something) and tuning variants.  Prints one line per kernel and shape, the
card's name and power limit, and a JSON line {"src", "edits", "card",
"times"}.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FWD = "kernels/csrc/flash_attention_fwd.cu"
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
    # tuning: no minimum of CTAs an SM (up to 255 registers) at D <= 80
    "no_min_ctas": [(FWD, "__launch_bounds__(kThreads, D <= 80 ? 3 : 1)",
                     "__launch_bounds__(kThreads, 1)")],
    # tuning: 32-key tiles at every head dim
    "k32": [(FWD, "return D > 128 ? 32 : 64;", "return 32;")],
}


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
    """(name, shape, call) of every kernel and shape timed, with chip_smoke's inputs."""
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
    for case in (cs.WKV_PREFILL, cs.WKV_DECODE):
        args = cs.wkv_inputs(case, cs.PATH_DTYPE["wkv6_fwd"])
        out.append(("wkv6_fwd", case, lambda args=args: cs.wkv_kernel.wkv6_fwd(*args)))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src directory whose repro_torch is timed")
    parser.add_argument("--edit", action="append", default=[], choices=sorted(EDITS),
                        help="an edit of the kernel sources (repeatable)")
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
    runs: dict = {}
    timed = cases(cs)
    for _ in range(3):
        for i, (_, _, fn) in enumerate(timed):
            for key, hold in (("ms", False), ("device_ms", True)):
                runs.setdefault((i, key), []).append(cs.time_ms(fn, hold=hold))
    times = []
    for i, (name, shape, _) in enumerate(timed):
        entry = {"name": name, "shape": list(shape),
                 **{key: sorted(runs[(i, key)])[1] for key in ("ms", "device_ms")}}
        times.append(entry)
        print(f"{name} {shape}: ms {entry['ms']:.4f} device_ms {entry['device_ms']:.4f}")
    card = cs.nvidia_smi()
    print(card)
    print(json.dumps({"src": str(src), "edits": args.edit, "card": card, "times": times}))


if __name__ == "__main__":
    main()

"""Batched serving driver of the port: prefill once, then greedy decode.

The port of `repro.launch.serve`: fixed-batch slots, greedy decode,
per-request stop lengths, KV caches managed by the model's cache protocol.
Decode is an eager Python loop (the JAX driver jits its step).

Run on the card (random weights from a seed, scaled-down config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
Run on the CPU with the plain versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
`--arch` takes any id of `repro_torch.configs.ARCHS` and defaults to the
reference's rwkv6-3b; the recurrent archs (rwkv6-3b, recurrentgemma-9b) keep
their recurrent states in the caches.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.model import greedy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)


@torch.inference_mode()
def serve_requests(cfg, model, requests: list[Request], max_seq: int,
                   progress=print, device=None) -> dict[int, list[int]]:
    """Batch all requests together (same prompt length), prefill once, decode
    until every request hits its token budget.  Returns rid -> token ids.

    Runs on `device` (default `cuda`), where `model` must already live, under
    `torch.inference_mode()`: the parameters are trainable, and serving
    builds no autograd graph.

    On a mesh (tensor parallelism over its 'model' axis), as the reference's
    dry run builds its prefill and decode steps: every rank shards the model
    (`launch.shardings.shard_model(model, mesh, fsdp=False)`, or
    `launch.shardings.init_sharded(..., mesh, fsdp=False)`) and calls this with
    the same requests inside `models.sharding.activation_sharding(mesh,
    launch.shardings.activation_rules(mesh))`; each rank computes its heads
    and channels, its caches hold them, and every rank returns the same
    tokens.  The greedy pick reads each rank's vocab slice of the logits
    (`models.model.greedy`), so no rank holds the whole vocab's."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model on {model.device}, serving on {dev}")
    batch = len(requests)
    prompts = torch.from_numpy(np.stack([r.prompt for r in requests])).to(model.device)
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, model, {"tokens": prompts}, max_seq=max_seq,
                             logits_whole=False)
    tok = greedy(cfg, model, logits)[:, None]
    host_tok = tok.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    n = prompts.numel()
    progress(f"prefill: {batch} x {prompts.shape[1]} tokens in {dt:.3f}s "
             f"({n / max(dt, 1e-9):.1f} tok/s)")

    budget = max(r.max_new_tokens for r in requests)
    t0 = time.perf_counter()
    for i in range(budget):
        for r, t in zip(requests, host_tok[:, 0].tolist(), strict=True):
            if len(r.out) < r.max_new_tokens:
                r.out.append(t)
        if i == budget - 1:
            break
        logits, caches = decode_step(cfg, model, tok, caches, logits_whole=False)
        tok = greedy(cfg, model, logits)[:, None]
        host_tok = tok.cpu()
    dt = time.perf_counter() - t0
    # the first token of each request came from prefill; count only decode's
    decoded = sum(max(len(r.out) - 1, 0) for r in requests)
    progress(f"decode: {decoded} tokens in {budget - 1} steps, {dt:.3f}s "
             f"({decoded / max(dt, 1e-9):.1f} tok/s)")
    return {r.rid: r.out for r in requests}


def build_parser() -> argparse.ArgumentParser:
    """The reference's options and defaults, and `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    return ap


def main():
    args = build_parser().parse_args()

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).scaled_down()
    generator = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, generator, dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    out = serve_requests(cfg, model, reqs,
                         max_seq=args.prompt_len + args.new_tokens + 1,
                         device=dev)
    for rid, toks in out.items():
        print(f"request {rid}: {toks}")


if __name__ == "__main__":
    main()

"""Serving example on the PyTorch port: prefill + batched greedy decode with
KV/recurrent caches.

The twin of examples/serve_decode.py: the same options, steps and printed
lines, with `repro_torch` in place of the JAX package and `--device`
(default: the card).  It exercises all three cache families of the zoo:
  - sliding-window ring buffers (gemma3-4b),
  - MLA latent cache with weight-absorbed decode (minicpm3-4b),
  - O(1) recurrent state (rwkv6-3b).
On the card the scaled-down (float32) configs run the hand-written kernels:
the flash-attention forward (B1) in prefill, and rwkv6-3b's WKV-6 (B5) in
prefill and in each decode step.  The prompt is drawn with a
`torch.Generator`; `generate` takes any prompt, so a test can give both
scripts the same one.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--arch rwkv6-3b] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models import decode_step, forward, init_params, prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def generate(cfg, model, prompt: torch.Tensor, new_tokens: int, say=print):
    """Prefill `prompt` (B, P) on the model's device, decode `new_tokens` - 1
    greedy steps, and check the greedy path against a full forward, printing
    the original's lines through `say`.  Returns (the generated ids (B,
    new_tokens), the greedy agreement in [0, 1])."""
    dev = model.device
    batch, prompt_len = prompt.shape
    prompt = prompt.to(dev)
    max_seq = prompt_len + new_tokens + 1

    t0 = time.time()
    logits, caches = prefill(cfg, model, {"tokens": prompt}, max_seq=max_seq)
    _sync(dev)
    say(f"prefill {prompt_len} tokens x {batch} seqs: {time.time() - t0:.2f}s")

    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    t0 = time.time()
    for _ in range(new_tokens - 1):
        logits, caches = decode_step(cfg, model, tok, caches)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    dt = time.time() - t0
    gen = torch.cat(out, dim=1)
    say(f"decoded {new_tokens - 1} steps in {dt:.2f}s "
        f"({(new_tokens - 1) * batch / dt:.1f} tok/s)")
    say(f"generated ids (batch 0): {gen[0].tolist()}")

    # consistency check vs full forward (greedy path must agree)
    full = torch.cat([prompt, gen.to(prompt.dtype)], dim=1)
    ref = forward(cfg, model, {"tokens": full}, mode="train").logits
    ref_tok = torch.argmax(ref[:, prompt_len - 1:-1, :], dim=-1)
    agree = float((ref_tok == gen).float().mean())
    say(f"greedy agreement with full forward: {agree * 100:.1f}%")
    return gen.cpu(), agree


def main(argv=None, say=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(configs.ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).scaled_down()
    if cfg.enc_dec or cfg.frontend != "none":
        raise SystemExit("pick a text-only arch for this example")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    return generate(cfg, model, prompt, args.new_tokens, say)


if __name__ == "__main__":
    main()

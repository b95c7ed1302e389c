"""End-to-end training driver on the PyTorch port: train a reduced LM for a
few hundred steps.

The twin of examples/train_lm.py: the same options, defaults, printed lines
and gate, with `repro_torch.launch.train.train` in place of the JAX
package's, and `--device` (default: the card, where the flash-attention
forward and backward kernels, B1, B2 and B3, run in every step).  Loss must
fall well below the uniform baseline ln(V).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--arch stablelm-3b]
      [--steps 300] [--grad-sync bridge] [--device cpu]
"""
import argparse
import math

from repro_torch import configs
from repro_torch.launch.train import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=list(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--grad-sync", default="gspmd",
                    choices=["gspmd", "bridge", "bridge-compressed"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    tc = TrainConfig(arch=args.arch, steps=args.steps,
                     batch_size=args.batch_size, seq_len=args.seq_len,
                     grad_sync=args.grad_sync,
                     checkpoint_dir=args.checkpoint_dir,
                     lr=1e-3, warmup=20)
    cfg = configs.get(args.arch).scaled_down()
    uniform = math.log(cfg.vocab_size)
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model} "
          f"V={cfg.vocab_size}); uniform-baseline loss = ln(V) = {uniform:.3f}")

    def progress(msg):
        print(msg, flush=True)

    _, _, losses = train(tc, progress=progress, device=args.device)
    print(f"\nfirst loss {losses[0]:.3f} -> last loss {losses[-1]:.3f} "
          f"(uniform {uniform:.3f})")
    if not losses[-1] < uniform * 0.8:
        raise SystemExit("model failed to learn")
    print("OK: model learned the synthetic structure.")
    return losses


if __name__ == "__main__":
    main()

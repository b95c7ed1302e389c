"""Deterministic, shard-aware, resumable synthetic-LM data pipeline.

A copy of `repro.data.pipeline.SyntheticLM` as it is (NumPy only), so the
port and the JAX package train on bit-identical batches, and of
`make_batch_specs`, the dry run's inputs, as (shape, torch dtype) pairs in
place of `jax.ShapeDtypeStruct`s.

Design requirements at 1000+ nodes (DESIGN.md S5):
  - *counter-based*: batch(step, shard) is a pure function of (seed, step,
    shard), so restart/resume = "set the step counter"; no iterator state to
    checkpoint, no skew after elastic re-sharding (shards are re-derived from
    the new topology).
  - *straggler-tolerant*: shards are independent; a backup worker can
    recompute any shard's batch bit-identically.

The token stream is a noisy affine-recurrence language
    t_{i+1} = (a * t_i + c + noise) mod V
so a model can actually learn it (loss decreases in examples/train_lm.py),
while remaining fully synthetic and offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    noise: float = 0.05
    mult: int = 31
    add: int = 17

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def batch(self, step: int, shard: int, batch_size: int) -> dict:
        """Returns {'tokens': (B, S) int32, 'labels': (B, S) int32}."""
        rng = self._rng(step, shard)
        v, s = self.vocab_size, self.seq_len
        t0 = rng.integers(0, v, size=(batch_size, 1))
        toks = [t0]
        for _ in range(s):
            nxt = (toks[-1] * self.mult + self.add) % v
            flip = rng.random((batch_size, 1)) < self.noise
            rand = rng.integers(0, v, size=(batch_size, 1))
            toks.append(np.where(flip, rand, nxt))
        seqs = np.concatenate(toks, axis=1)  # (B, S+1)
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def global_batch(self, step: int, num_shards: int,
                     per_shard_batch: int) -> dict:
        """Concatenation of all shards' batches (host-side global view)."""
        parts = [self.batch(step, sh, per_shard_batch)
                 for sh in range(num_shards)]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}


def make_batch_specs(cfg, shape, dtype_tokens=torch.int32) -> dict:
    """{name: (shape, dtype)} of one (arch, shape) cell's batch: the dry-run
    inputs, with the reference's keys, shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        return {"tokens": ((B, 1), dtype_tokens)}
    text_S = S - (cfg.frontend_seq if cfg.frontend == "patch_stub" else 0)
    specs = {"tokens": ((B, text_S), dtype_tokens),
             "labels": ((B, text_S), dtype_tokens)}
    if cfg.frontend == "patch_stub":
        specs["patches"] = ((B, cfg.frontend_seq, cfg.d_model), torch.float32)
    if cfg.enc_dec:
        specs["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    return specs

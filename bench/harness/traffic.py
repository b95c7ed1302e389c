"""The one generator of the benchmark's inputs.  Every draw is a pure
function of (seed, what, index): the same seed gives the same weights,
batches and prompts in every run, on any number of ranks."""
from __future__ import annotations

import numpy as np
import torch

WEIGHTS, TRAIN, SERVE, WARM, SAMPLE = range(5)


def stream_seed(seed: int, what: int, index: int = 0) -> int:
    """A 63-bit seed for stream (`what`, `index`) of the run's `seed`, which
    may be any whole number."""
    state = np.random.SeedSequence([seed % 2 ** 64, what, index]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, what: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, what, index))


def train_batch(seed: int, step: int, traffic: dict, vocab: int, device, rank: int = 0) -> dict:
    """Step `step`'s rows of this rank: uniform ids over the whole global
    batch (the same on every rank), tokens and labels shifted by one."""
    rows, seq = traffic["batch_per_rank"], traffic["seq"]
    ids = torch.randint(0, vocab, (rows * traffic["ranks"], seq + 1), device=device,
                        generator=generator(seed, TRAIN, step, device))
    mine = ids[rank * rows:(rank + 1) * rows]
    return {"tokens": mine[:, :-1].to(torch.int32), "labels": mine[:, 1:].to(torch.int32)}


def serve_prompts(seed: int, what: int, index: int, traffic: dict, vocab: int) -> np.ndarray:
    """(requests, prompt) int32 uniform ids of one offline batch."""
    rng = np.random.default_rng(stream_seed(seed, what, index))
    return rng.integers(0, vocab, (traffic["requests"], traffic["prompt"]), dtype=np.int32)


def sample(seed: int, population: int, k: int) -> list[int]:
    """k distinct indices of `population`, drawn from the seed."""
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    return sorted(rng.choice(population, size=min(k, population), replace=False).tolist())

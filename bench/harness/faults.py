"""Faults planted in the program under test, to show that the comparison
catches them (`tests/test_bench_faults.py` on the CPU, `calibrate.py` on the
card at the cells' sizes).  The timed runs never plant one.

  unchanged    a training step that leaves the parameters and the optimizer
               state as they were (no update)
  half_batch   a training step on half of its rows, the loss's mean taken
               over them
  no_exchange  the gradients of each rank used as they are, never summed
               across the cards
  rank1_unsynced  the exchange runs, but rank 1 drops its result and keeps
               its own gradients (every other rank is right)
  stale_state  a decode step that leaves the recurrent states where prefill
               put them (each step reads the prompt's state)
  half_served  half of a batch's requests left out, never answered
  token        every served token altered where the greedy pick makes it
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_mod

    target, attr, repl = {
        "unchanged": (train_mod, "adamw_update", _no_update),
        "half_batch": (train_mod, "loss_fn", _half_rows(train_mod.loss_fn)),
        "no_exchange": (train_mod, "sync_gradients",
                        lambda grads, mode, world, ef=None: (grads, ef)),
        "rank1_unsynced": (train_mod, "sync_gradients",
                           _rank1_unsynced(train_mod.sync_gradients)),
        "stale_state": (model_mod, "_keep", lambda held, new: None),
        "half_served": (serve_mod, "serve_requests", _half_served(serve_mod.serve_requests)),
        "token": (serve_mod, "greedy", _altered(serve_mod.greedy)),
    }[name]
    saved = getattr(target, attr)
    setattr(target, attr, repl)
    try:
        yield
    finally:
        setattr(target, attr, saved)


def _no_update(grads, state, params, lr, **_):
    import torch
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    return params, state, {"grad_norm": gnorm, "lr": torch.zeros_like(gnorm)}


def _half_rows(loss_fn):
    def half(cfg, model, batch, *args, **kw):
        rows = batch["tokens"].shape[0]
        return loss_fn(cfg, model, {k: v[:max(rows // 2, 1)] for k, v in batch.items()},
                       *args, **kw)
    return half


def _rank1_unsynced(sync):
    def own(grads, mode, world, ef=None):
        import torch.distributed as dist
        mine = [g.clone() for g in grads]
        out, ef = sync(grads, mode, world, ef)
        return (mine if dist.get_rank() == 1 else out), ef
    return own


def _half_served(serve_requests):
    def half(cfg, model, requests, *args, **kw):
        return serve_requests(cfg, model, requests[:len(requests) // 2], *args, **kw)
    return half


def _altered(greedy):
    def pick(cfg, params, logits):
        return (greedy(cfg, params, logits) + 1) % logits.shape[-1]
    return pick

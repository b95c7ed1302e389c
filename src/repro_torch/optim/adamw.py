"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

A copy in torch of `repro.optim.adamw` with the same defaults and the same
arithmetic: moments are float32 whatever the parameter dtype, the update is
done in float32 and cast back, the step counter is incremented before
`lr(step)` is read.  Parameters, gradients and moments are lists of tensors
in one order (`list(model.parameters())`).  Unlike the JAX version, which
returns new arrays, `adamw_update` writes the parameters and the moments in
place under `torch.no_grad()`, and scales each gradient leaf by the clip
factor as it goes instead of materialising all clipped leaves first (the
same numbers, without an f32 copy of every gradient).  `torch.optim.AdamW`
is not used: its defaults and its clipping differ from the reference.

Sharded parameters (DTensors, `launch.shardings.shard_model`) are updated on
their local shards, with moments of the shard's shape: AdamW is elementwise,
so each shard's arithmetic is the reference's.  The global gradient norm
sums the squares of every rank's shards and all-reduces the sum over the
mesh (the whole world); a leaf replicated over mesh axes (norms, biases, the
router over 'model', any leaf whose rule's guard dropped an axis) holds the
same gradient on each of its copies, so its square sum is divided by its
number of copies and the leaf counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # int32 scalar
    m: list[torch.Tensor]       # f32, one per parameter
    v: list[torch.Tensor]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    def zeros(p):
        return torch.zeros(_local(p).shape, dtype=torch.float32, device=p.device)
    dev = params[0].device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=[zeros(p) for p in params], v=[zeros(p) for p in params])


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """This rank's part of the sum of squares of the whole gradient `g`."""
    total = torch.sum(torch.square(_local(g).float()))
    if isinstance(g, DTensor):
        copies = math.prod(g.device_mesh.size(i) for i, pl in enumerate(g.placements)
                           if isinstance(pl, Replicate))
        if copies > 1:
            total = total / copies
    return total


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    total = sum(_square_sum(g) for g in grads)
    if any(isinstance(g, DTensor) for g in grads):  # the mesh is the whole world
        dist.all_reduce(total)
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return [g.float() * scale for g in grads], gnorm


def cosine_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, min_ratio: float = 0.1
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * (step + 1) / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


@torch.no_grad()
def adamw_update(
    grads: Sequence[torch.Tensor],
    state: AdamWState,
    params: Sequence[torch.Tensor],
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> tuple[Sequence[torch.Tensor], AdamWState, dict]:
    """One step.  Returns (params, state, {"grad_norm", "lr"}); `params` and
    the moments are the same tensors, updated in place."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)
    lr_t = lr_t.to(step.device)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for p, g, m, v in zip(params, grads, state.m, state.v, strict=True):
        p, g = _local(p), _local(g).float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        pf = p.float()
        pf = pf - lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr_t}

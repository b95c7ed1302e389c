"""The card's backend for certified tape playback (``backend="torch"``).

The port's counterpart of the reference's `repro.core.batchsim_jax`, which
lowers the *certified* subset of `batchsim._play` to one jitted XLA program.
Here the same playback is the hand-written CUDA kernel B6
(`kernels/csrc/fabric_playback.cu`, wrapped by `kernels.playback.kernel`):

  - the `ScheduleTape` stacks (``nb_step`` / ``g_step`` / ``hops`` /
    ``changed``) and the per-lane ``delta_eff`` are copied to the device
    once a batch,
  - a lane plays on chip, on a cluster of up to 16 CTAs (the wrapper's
    `launch_plan`): the steps in order, its own hop counts, the chunks of
    every port, the lanes with the most hops launched first,
  - the results come back as NumPy float64 arrays in lane order.

Soundness gate.  The kernel has *no* canonical-order guards and *no* skew
knobs — it is only called for lanes holding a static fast-path certificate
(`repro_torch.analysis.certifier`), which proves the guards could not have
tripped and implies the lane is uniform.  Uncertified lanes never reach this
module: `batchsim.batch_run` keeps routing them through the guarded NumPy
playback with the scalar-oracle fallback.

Exactness.  Everything runs in float64, with the same float operations in
the same order as `_play` and as the XLA kernel, unfused; the result is
bit-identical to both.

The reference's ``max_buckets`` / ``min_bucket_size`` are gone: they sorted
lanes into buckets only to shorten `vmap`'s ``while_loop``, which runs every
lane through the longest lane's hop count.  Each lane's CTAs walk its own
hop counts, so there is nothing to pad and nothing to bucket.  Its
``compile_stats`` (XLA's trace count) has no counterpart either: the
wrapper's ``fabric_playback.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.playback.kernel import fabric_playback

from .cost_model import CostModel


def cuda_available(device=None) -> bool:
    """True when ``device`` (None: the card) names a CUDA device that exists:
    what ``backend="auto"`` asks, as the reference asks `jax_available()`."""
    return (device is None or torch.device(device).type == "cuda") \
        and torch.cuda.is_available()


def play_certified(*, n: int, C: int, cm: CostModel, nb_step: np.ndarray,
                   g_step: np.ndarray, hops: np.ndarray, changed: np.ndarray,
                   delta_eff: np.ndarray, device=None):
    """Guard-free playback of a certified-lane batch on ``device`` (None: the
    card, raising without one; ``"cpu"``: the kernel's plain version).

    Inputs are the ``[B, S]`` tape stacks `batchsim.batch_run` builds
    (``nb_step`` per-node payload bytes, ``g_step`` link offsets, ``hops``
    per-step hop counts, ``changed`` rewiring-boundary mask, per-lane
    ``delta_eff``).  Every lane MUST hold a static fast-path certificate —
    the caller (`batch_run`) enforces this; uniformity is what licenses
    dropping the per-port speed/scale arrays and the runtime guards.

    Returns ``(node_done [B, n], step_done [B, S], port_free [B, n])`` as
    NumPy float64 arrays in lane order.
    """
    dev = resolve_device(device)
    ch = np.array(changed, dtype=bool)
    ch[:, 0] = False          # step 0 never charges delta (x[0] == 0)
    g, h = (np.asarray(a, dtype=np.int64) for a in (g_step, hops))
    if min(g.min(), h.min()) < -2**31 or max(g.max(), h.max()) >= 2**31:
        raise ValueError("g_step and hops must fit int32")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    out = fabric_playback(
        put(nb_step, np.float64), put(g, np.int32), put(h, np.int32), put(ch, np.uint8),
        put(delta_eff, np.float64), n=n, C=C, alpha_s=cm.alpha_s, alpha_h=cm.alpha_h,
        beta=cm.beta)
    return tuple(t.cpu().numpy() for t in out)

"""Certified fabric playback: the plain PyTorch version of kernel B6.

The function of `csrc/fabric_playback.cu` and of the reference's jitted XLA
playback (`batchsim_jax._kernel`), written as `batchsim._play` computes it
with ``check_order=False`` on uniform lanes: batched over the ``[B, n]``
ports, a Python loop over the steps, over the longest lane's hops with an
active mask, and over the chunks, in float64 and in the same order of
float operations, so the three agree bit for bit.

Per lane and step k: ``F += delta_eff`` where ``changed[k]``; the injection
``recv + alpha_s``; ``tau = (nb[k] / C) * beta``; then for each of
``hops[k]`` hops and each chunk c, ``f = max(f, arrival[c]) + tau`` at every
port, the next hop's arrivals gathered from port ``(p - g[k]) mod n`` plus
``alpha_h``.  The last hop's chunk C - 1, gathered the same way, is
``recv``; ``step_done[k]`` its maximum.  A step with no hops leaves
``recv`` as it was (the XLA version's while loop does the same).
"""
from __future__ import annotations

import torch


def fabric_playback(nb, g, hops, changed, delta_eff, *, n: int, C: int,
                    alpha_s: float, alpha_h: float, beta: float):
    """nb: (B, S) float64 per-node bytes of each step; g, hops: (B, S) integer
    link offsets and hop counts; changed: (B, S) bool or uint8, the steps
    whose opening boundary charges delta_eff (B,) float64.

    Returns (node_done, step_done, port_free): (B, n), (B, S), (B, n) float64.
    """
    B, S = nb.shape
    dev = nb.device
    ports = torch.arange(n, device=dev)[None, :]
    changed = changed.bool()
    F = torch.zeros((B, n), dtype=torch.float64, device=dev)
    recv = torch.zeros((B, n), dtype=torch.float64, device=dev)
    step_done = torch.empty((B, S), dtype=torch.float64, device=dev)
    comp = torch.empty((B, n, C), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    for k in range(S):
        F = F + torch.where(changed[:, k], delta_eff, zero)[:, None]
        inj = recv + alpha_s
        h = hops[:, k]
        tau = ((nb[:, k] / C) * beta)[:, None]
        gather_idx = torch.remainder(ports - g[:, k, None].long(), n)
        gather_idx3 = gather_idx[:, :, None].expand(B, n, C)
        arr = inj[:, :, None].expand(B, n, C)
        for j in range(int(h.max())):
            active = (j < h)[:, None]
            f = F
            for c in range(C):
                f = torch.maximum(f, arr[:, :, c]) + tau
                comp[:, :, c] = f
            F = torch.where(active, f, F)
            nxt = torch.gather(comp, 1, gather_idx3) + alpha_h
            recv = torch.where(active & (j + 1 >= h)[:, None], nxt[:, :, C - 1], recv)
            arr = nxt
        step_done[:, k] = recv.amax(dim=1)
    return recv, step_done, F

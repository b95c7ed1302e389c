"""The benchmark's yardstick: the frozen bound reproduces the bound_ms that
the port's chip check printed at PERF.md's shapes, and the references'
model-FLOP formulas agree with `torch.utils.flop_counter` on a small
configuration."""
from __future__ import annotations

import pytest
import torch
from conftest import TINY, TINY_RWKV, tiny_cell
from torch.utils.flop_counter import FlopCounterMode

from harness import roofline as rl

# (work, bound_ms as PERF.md's kernel table records it, rounded to 4 places)
CASES = [
    ("B1 serve (4, 32, 512, D 80)", rl.flash_fwd_work(4, 32, 32, 512, 512, 80, True), 0.0126),
    ("B1 train (8, 32, 512, D 80)", rl.flash_fwd_work(8, 32, 32, 512, 512, 80, True), 0.0252),
    ("B2 train (8, 32, 512, D 80)", rl.flash_bwd_dkv_work(8, 32, 512, 512, 80, True), 0.0379),
    ("B3 train (8, 32, 512, D 80)", rl.flash_bwd_dq_work(8, 32, 512, 512, 80, True), 0.0316),
    ("B5 prefill (4, 40, 512, 64)", rl.wkv_work(4, 40, 512, 64, 64, True), 0.0172),
    ("B5 decode (4, 40, 1, 64)", rl.wkv_work(4, 40, 1, 64, 64, True), 0.0016),
    ("B5 training (8, 40, 512, 64)", rl.wkv_work(8, 40, 512, 64, 64, False), 0.0329),
]


@pytest.mark.parametrize("name,work,want", CASES, ids=[c[0] for c in CASES])
def test_bound_reproduces_the_chip_checks_bound_ms(name, work, want):
    ms, by = rl.bound(*work)
    assert round(ms, 4) == want, (name, ms)
    assert by == "bytes"


def test_live_pairs_of_the_masks():
    assert rl.live_pairs(4, 4, True, None) == 10
    assert rl.live_pairs(4, 4, False, None) == 16
    assert rl.live_pairs(8, 8, True, 3) == 3 * 8 - 3
    assert rl.live_pairs(2, 5, True, None) == 4 + 5


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_dense_step_flops_agree_with_the_flop_counter():
    cell = tiny_cell("stablelm-3b.train")
    ref, arch = cell.reference(), cell.arch
    gen = torch.Generator().manual_seed(0)
    tree = ref.draw(arch, gen, torch.float32)
    leaves = []

    def grad(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t.requires_grad_())
            return t
        return [grad(x) for x in t] if isinstance(t, list) else {k: grad(v) for k, v in t.items()}

    tree = grad(tree)
    b, s = 2, 24
    ids = torch.randint(0, arch["vocab_size"], (b, s + 1), generator=gen)

    def step():
        ref.nll_sum(arch, tree, ids[:, :-1], ids[:, 1:], "f32").backward()

    # the reference's plain attention computes every (query, key) pair
    assert _counted(step) == ref.step_flops(arch, b, s, causal=False)
    assert ref.step_flops(arch, b, s) < ref.step_flops(arch, b, s, causal=False)


def test_rwkv6_token_flops_agree_with_the_flop_counter():
    cell = tiny_cell("rwkv6-3b.serve")
    ref, arch = cell.reference(), cell.arch
    assert arch["rwkv_head_dim"] == TINY_RWKV["rwkv_head_dim"]
    assert arch["d_model"] == TINY["d_model"]
    gen = torch.Generator().manual_seed(1)
    tree = ref.draw(arch, gen, torch.float32)
    ids = torch.randint(0, arch["vocab_size"], (2, 12), generator=gen)
    with torch.no_grad():
        counted = _counted(lambda: ref.logits(arch, tree, ref.hidden(arch, tree, ids, "f32"),
                                              "f32"))
    assert counted == ref.token_flops(arch) * ids.numel()

"""Selective remat, `remat_policy="dots"`, of `repro_torch.models`.

"dots" is JAX's `dots_with_no_batch_dims_saveable`: each block runs under
`torch.utils.checkpoint` with a selective-checkpoint context that saves the
output of every matrix product without batch dimensions and recomputes the
rest.  Held here on the CPU, at f32, scaled down:
  - the loss and every gradient equal full remat's (and no remat's) bit for
    bit: a saved product is the one the recompute would give;
  - counted under a `TorchDispatchMode` over one backward: "dots" recomputes
    no forward projection (`aten.mm`) but every batched product (`aten.bmm`:
    the MoE experts, the plain attention, the plain recurrences), "full"
    recomputes them all, "none" neither;
  - the products the port saves for one block against the dot outputs that
    `jax.ad_checkpoint.saved_residuals` reports for the reference's block;
  - `train()` takes a model whose config carries the policy.
Held to the JAX package's "dots" at GRAD_TOL in
`tests/test_torch_train.py::test_loss_and_grads_match_jax`.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import (checkpoint,  # noqa: E402
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from _torch_parity import port_cfg  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.train import TrainConfig, model_config, train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import apply_block, dots_policy, forward, loss_fn  # noqa: E402

POLICIES = ("full", "dots", "none")
TEXT_ARCHS = ["stablelm-3b", "gemma3-4b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
              "rwkv6-3b", "minicpm3-4b", "arctic-480b", "command-r-plus-104b"]


def _cfg(arch, policy):
    cfg = configs.get(arch).scaled_down()
    if arch == "gemma3-4b":  # a window shorter than the sequence: masked tiles
        cfg = dataclasses.replace(cfg, window=8)
    return dataclasses.replace(cfg, dtype="float32", remat_policy=policy)


def _batch(cfg, seq=16, rows=2):
    host = SyntheticLM(cfg.vocab_size, seq, seed=1).global_batch(0, rows, 1)
    return {k: torch.from_numpy(v) for k, v in host.items()}


class _Count(TorchDispatchMode):
    """Counts the aten ops that reach the dispatcher, by overload packet."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket] += 1
        return func(*args, **(kwargs or {}))


def _run(arch, policy):
    """(loss, gradients, ops counted in the backward) of one step of `arch`
    under `policy`, from seed 0's weights."""
    cfg = _cfg(arch, policy)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, _ = loss_fn(cfg, model, _batch(cfg))
    with _Count() as count:
        loss.backward()
    return loss.item(), [p.grad for p in model.parameters()], count.ops


@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_dots_gives_the_bits_of_full_remat(arch):
    """A saved product is the one the recompute would give, so the loss and
    every gradient equal full remat's, and no remat's, bit for bit."""
    runs = {policy: _run(arch, policy) for policy in POLICIES}
    for policy in ("dots", "none"):
        loss, grads, _ = runs[policy]
        assert loss == runs["full"][0], policy
        for i, (got, want) in enumerate(zip(grads, runs["full"][1], strict=True)):
            assert torch.equal(got, want), (policy, i)


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-moe-235b-a22b"])
def test_dots_recomputes_no_projection_but_every_batched_product(arch):
    """One backward under each policy, its ops counted.  The forward of the
    blocks runs P projections (`aten.mm`, x (N, d) @ w (d, f)) and B batched
    products (`aten.bmm`: the plain attention's two, and on qwen3-moe the
    dispatch, the three expert products and the combine).  "full" runs all
    of them again in the backward, "dots" the batched ones only, "none"
    neither.  Counted with the recompute's early stop off, so that it runs
    each block to its end (by default it stops at the last op whose output
    the backward reads, before the block's last projection)."""
    cfg = _cfg(arch, "none")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), _Count() as fwd:
        forward(cfg, model, _batch(cfg), mode="train")
    aten = torch.ops.aten
    # the unembedding's product is outside the blocks: never recomputed
    projections, batched = fwd.ops[aten.mm] - 1, fwd.ops[aten.bmm]
    with set_checkpoint_early_stop(False):
        counts = {policy: _run(arch, policy)[2] for policy in POLICIES}
    none = counts["none"]
    # q, k, v, o (and the FFN's, or the router) a layer; two attention products
    assert projections > 4 * cfg.num_layers and batched >= 2 * cfg.num_layers
    if cfg.ffn == "moe":
        assert batched == 7 * cfg.num_layers
    assert counts["full"][aten.mm] == none[aten.mm] + projections
    assert counts["full"][aten.bmm] == none[aten.bmm] + batched
    assert counts["dots"][aten.mm] == none[aten.mm]
    assert counts["dots"][aten.bmm] == none[aten.bmm] + batched


def _port_saved(cfg, kind, x, positions):
    """Shapes of the outputs the "dots" policy saves in one block's forward."""
    saved = []

    def recording(ctx, op, *args, **kwargs):
        policy = dots_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and policy.name == "MUST_SAVE":
            saved.append(tuple(ctx.op_output.shape))
        return policy

    model = init_params(dataclasses.replace(cfg, num_layers=1, pattern=(kind,)),
                        torch.Generator().manual_seed(0), "cpu")
    block = model.blocks[0]
    x = torch.from_numpy(x).requires_grad_()
    out, _, _ = checkpoint(apply_block, cfg, block, kind, x, torch.from_numpy(positions),
                           use_reentrant=False, context_fn=functools.partial(
                               create_selective_checkpoint_contexts, recording))
    out.sum().backward()
    return saved


def _jax_saved(cfg, kind, x, positions):
    """(shapes of the dot outputs among the residuals that the reference's
    block saves under `dots_with_no_batch_dims_saveable`, shapes of all the
    residuals that are not its arguments or constants)."""
    params = jax_model.init_block(cfg, jax.random.PRNGKey(0), kind, jnp.float32)
    fn = jax.checkpoint(
        lambda p, x: jax_model.apply_block(cfg, p, kind, x, jnp.asarray(positions))[0],
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    residuals = [(r[0].shape, r[1]) for r in saved_residuals(fn, params, jnp.asarray(x))]
    computed = [s for s, why in residuals if "argument" not in why and "constant" not in why]
    # `layers.dot` is the reference's one matrix-product helper: its outputs
    return [s for s, why in residuals if why.endswith("(dot)")], computed


def _flat(shape):
    """A product's output as (elements, columns): the port's (B*S, f) is
    the reference's (B, S, f)."""
    return (int(np.prod(shape)), shape[-1])


@pytest.mark.parametrize("arch", ["stablelm-3b", "rwkv6-3b", "minicpm3-4b",
                                  "recurrentgemma-9b"])
def test_saved_products_are_the_references_saved_dots(arch):
    """One block: every dot output that `saved_residuals` reports for the
    reference's block under "dots" is among the products the port saves,
    and every product the port saves has the shape of a residual the
    reference keeps.  The port's storage also holds the few products whose
    outputs no backward reads (the block's last projection, before the
    residual add), which JAX drops from its residuals, and on stablelm-3b the
    gate projection that JAX keeps as silu of it, the same shape.  (The MoE
    block differs by design: the reference maps its groups with `lax.map`,
    so each group's dispatch is a product without batch dimensions that it
    saves; the port dispatches every group in one batched product, which it
    recomputes.)"""
    jcfg = dataclasses.replace(jax_configs.get(arch).scaled_down(), dtype="float32")
    cfg = port_cfg(jcfg)
    kind = cfg.layer_kinds[0]
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16)).copy()
    got = collections.Counter(_flat(s) for s in _port_saved(cfg, kind, x, positions))
    dots, computed = _jax_saved(jcfg, kind, x, positions)
    want = collections.Counter(_flat(s) for s in dots)
    assert want and not want - got, (want, got)
    assert set(got) <= {_flat(s) for s in computed}, (got, computed)


def test_train_takes_a_model_with_the_dots_policy():
    """`train()`'s model seam takes a config that differs in `remat_policy`
    (and depth) and trains under that policy: the same losses and final
    weights as the run under "full", bit for bit."""
    tc = TrainConfig(arch="stablelm-3b", steps=2, batch_size=4, seq_len=16)
    runs = []
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(model_config(tc), remat_policy=policy, num_layers=2)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out, _, losses = train(tc, lambda *_: None, device="cpu", model=model)
        assert out.cfg.remat_policy == policy
        runs.append((losses, [p.detach().clone() for p in out.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1], strict=True))

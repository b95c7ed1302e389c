"""Two readings behind choices in the recurrences' gradient tests, printed
rather than asserted (they describe the JAX package, which the port does not
control).

1. bf16 `log_w` given to the JAX op as it is.  The JAX op's backward takes
   exp(log_w) in log_w's dtype, so in bf16 it rounds the decay w to bf16; the
   port's backward takes it in f32.  For each reference test shape, the
   number of elements of each gradient outside the bf16 bound
   (2e-2 + 2e-2|want|), with the JAX op given log_w as bf16 and as f32
   holding the same values (what `test_torch_recurrent_bwd.py` does).

2. rwkv6-3b scaled down, f32, with and without remat: the gradient of the
   embedding table of the port (remat; its no-remat run gives the same bits)
   and of JAX with and without `jax.checkpoint`, each against an f64
   evaluation of the port's model (the same weights in float64, with the
   WKV-6 recurrence differentiated by autograd through its plain forward),
   and the number of elements outside GRAD_TOL of JAX's remat gradient.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/recurrent_bwd_readings.py
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_recurrent_bwd as rb
import test_torch_train as tt
from repro_torch.kernels.wkv6 import ref as wkv_ref
from repro_torch.models import recurrent


def bf16_log_w_reading():
    bound = lambda g, w: np.abs(g - w) - (2e-2 + 2e-2 * np.abs(w))  # noqa: E731
    for dims in rb.WKV_CASES:
        r, k, v, lw, u, _, gy, gs = rb._wkv_arrays(dims, seed=30, dtype="bfloat16")
        ins = (*(rb._t(x, "bfloat16") for x in (r, k, v, lw)), rb._t(u), None)
        got = rb.wkv_ref.wkv6_scan_bwd(*ins, rb._t(gy, "bfloat16"), rb._t(gs))
        for given in ("bfloat16", "float32"):
            want = rb._vjp(lambda *xs: rb.jax_wkv6(*xs),
                           (*(rb._j(x, "bfloat16") for x in (r, k, v)), rb._j(lw, given),
                            rb._j(u)), (rb._j(gy, "bfloat16"), rb._j(gs)))
            parts = []
            for name, g, w in zip(rb.WKV_NAMES, got, want):
                excess = bound(rb._np(g), rb._np(w))
                parts.append(f"{name} {int((excess > 0).sum())}/{excess.size} "
                             f"(worst excess {excess.max():.3g})")
            print(f"bf16 {dims}, JAX op given log_w as {given}: outside the bound: "
                  + ", ".join(parts))


def _port_f64_embed_grad(cfg, batch):
    """The port's model in float64: every `.float()` of the forward becomes
    `.double()`, and the WKV-6 op is autograd through the plain scan."""
    _, model = tt.both_params(cfg)
    model = copy.deepcopy(model).double()
    model.cfg = dataclasses.replace(model.cfg, dtype="float64")  # activations in f64 too
    to_float, op = torch.Tensor.float, recurrent.wkv6
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    recurrent.wkv6 = lambda r, k, v, lw, u, s0=None: wkv_ref.wkv6_scan(
        r, k, v, torch.exp(lw), u, s0)
    try:
        loss, _ = tt.loss_fn(model.cfg, model,
                             {k: torch.from_numpy(x) for k, x in batch.items()})
        assert loss.dtype == torch.float64
        loss.backward()
    finally:
        torch.Tensor.float, recurrent.wkv6 = to_float, op
    return tt.flatten(tt.tree_from_model(model, "grad"))["embed/table"]


def remat_reading():
    arch, key = "rwkv6-3b", "embed/table"
    batch = tt.JaxSyntheticLM(tt._cfg(arch, "none").vocab_size, 32, seed=1).global_batch(0, 4, 1)
    exact = _port_f64_embed_grad(tt._cfg(arch, "none"), batch)
    port = tt._loss_and_grads(tt._cfg(arch, "full"), batch)[2][key].astype(np.float64)
    grads = {"port (remat)": port}
    for remat in ("full", "none"):
        cfg = tt._cfg(arch, remat)
        jp, _ = tt.both_params(cfg)
        g = jax.grad(lambda p: tt.jax_loss_fn(
            cfg, p, {k: jnp.asarray(x) for k, x in batch.items()})[0])(jp)
        grads[f"JAX remat {remat}"] = tt.flatten(jax.tree.map(np.asarray, g))[key] \
            .astype(np.float64)
    for name, g in grads.items():
        print(f"{arch} {key}: {name} max |g - f64| {np.abs(g - exact).max():.3g}")
    want = grads["JAX remat full"]
    outside = np.abs(port - want) > tt.GRAD_TOL["atol"] + tt.GRAD_TOL["rtol"] * np.abs(want)
    print(f"{arch} {key}: port vs JAX remat full: max {np.abs(port - want).max():.3g}, "
          f"{int(outside.sum())}/{outside.size} outside GRAD_TOL")


if __name__ == "__main__":
    bf16_log_w_reading()
    remat_reading()

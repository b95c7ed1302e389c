"""Shared helpers of the `test_torch_*` parity tests (JAX package vs port)."""
import dataclasses

import jax
import numpy as np

from repro.models import init_params as jax_init_params
from repro_torch.interop import params_from_jax
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig


def port_cfg(jax_cfg):
    """The port's ArchConfig with the same fields as the JAX one."""
    fields = dataclasses.asdict(jax_cfg)
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    if fields["mla"] is not None:
        fields["mla"] = MLAConfig(**fields["mla"])
    return ArchConfig(**fields)


def both_params(jax_cfg, seed=0):
    """(JAX params, the port's Model with identical weights on the CPU)."""
    params = jax_init_params(jax_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(port_cfg(jax_cfg), tree, device="cpu")


def flatten(tree, prefix=""):
    """{"a/b/0/c": array} of a JAX-layout tree (dicts and lists) of arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def assert_trees_close(got, want, **tol):
    """Leaf by leaf: the port's tree (`repro_torch.interop.tree_from_model`)
    against a JAX tree; the same leaves, shapes and values within `tol`."""
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], np.asarray(w, np.float32), err_msg=key, **tol)

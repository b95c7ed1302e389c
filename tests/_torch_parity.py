"""Shared helpers of the `test_torch_*` parity tests (JAX package vs port)."""
import dataclasses

import jax
import numpy as np

from repro.models import init_params as jax_init_params
from repro_torch.interop import params_from_jax
from repro_torch.models.config import ArchConfig


def port_cfg(jax_cfg):
    """The port's ArchConfig with the same fields as the JAX one."""
    fields = dataclasses.asdict(jax_cfg)
    assert fields["moe"] is None and fields["mla"] is None
    return ArchConfig(**fields)


def both_params(jax_cfg, seed=0):
    """(JAX params, the port's Model with identical weights on the CPU)."""
    params = jax_init_params(jax_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(port_cfg(jax_cfg), tree, device="cpu")

"""Mesh construction of the port: the counterpart of `repro.launch.mesh`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with named axes:
  pod   : cross-pod data parallelism (and optional pipeline stages)
  data  : in-pod data parallelism + FSDP (params/optimizer sharded here)
  model : tensor parallelism + expert parallelism
Functions, not module-level constants, as in the reference: importing this
module touches no device and no process group.

A mesh of one rank outside `torchrun` gets a process group of its own: one
rank on an in-process store (`dist.HashStore`), so a single card (or the CPU)
runs the mesh paths unchanged.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device


def _ensure_world(size: int, device_type: str) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise ValueError(f"a mesh of {size} ranks on a world of "
                             f"{dist.get_world_size()}")
        return
    if size != 1:
        raise ValueError(f"a mesh of {size} ranks needs an initialised process "
                         f"group of {size} (torchrun)")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None) -> DeviceMesh:
    """A mesh of `shape` named `axes` over every rank, row-major (the last
    axis varies fastest, as in `jax.make_mesh`); on the card unless `device`
    says "cpu"."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes}")
    device_type = resolve_device(device).type
    _ensure_world(math.prod(shape), device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object with `axis_names`
    and a `shape` mapping names to sizes (a `jax.sharding.Mesh`, or a stand-in
    with no devices behind it)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape, strict=True))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch dimension: ('pod','data') when pod exists."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)

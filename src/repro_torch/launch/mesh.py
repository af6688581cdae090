"""Production mesh construction: 16×16 = 256 devices per pod, two pods
for the multi-pod cells.

A FUNCTION, not a module-level constant — importing this module never
touches device state.

Port of ``repro/launch/mesh.py``.  :func:`make_production_mesh` and
:func:`make_mesh` keep the reference's shapes and axis names, so every
cell's specs can be held equal to JAX's; the dry-run passes
``devices=["meta"] * n``.  :func:`process_mesh` is the port's own: the
``torch.distributed`` ``DeviceMesh`` of the running ranks, which the
multi-rank trainer steps on.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..parallel.compat import Mesh
from ..parallel.compat import make_mesh as _make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")`` with ``multi_pod``.  Without ``devices``
    it takes that many CUDA devices and raises if there are fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, devices)


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """Arbitrary mesh (tests, examples)."""
    return _make_mesh(tuple(shape), tuple(axes), devices)


def process_mesh(shape: Sequence[int], axes: Sequence[str], *,
                 device: str = "cuda"):
    """The ``DeviceMesh`` of the running ranks over ``axes``, one rank a
    device: NCCL on cards (each rank on ``cuda:<local rank>``), gloo when
    ``device="cpu"``.  The default process group must be up
    (:func:`repro_torch.launch.train.init_ranks` starts it) and its world
    size must be ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks, the group has {dist.get_world_size()}")
    kind = torch.device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=tuple(axes))

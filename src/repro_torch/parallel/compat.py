"""The mesh the sharded runner is bound to, on torch devices.

Port of the imports ``repro/parallel/compat.py`` and the sharded runner
take from JAX: ``jax.sharding.Mesh``, ``jax.make_mesh`` and ``shard_map``.
The JAX runner is single-controller: one process drives every device of
the mesh, and ``shard_map`` runs one body per device.  The port keeps that
model.  A :class:`Mesh` is a tuple of ``torch.device`` s laid out over
named axes, and :func:`shard_map` calls a body once per device along one
axis, in order, with that device current; the bodies exchange tensors with
``Tensor.to`` (a copy between two cards is ordered after the work queued on
both current streams, which is what a collective's ordering gives JAX).

There is no ``torch.distributed`` here: NCCL refuses two ranks on one
card, so a mesh that repeats a device (``["cuda:0"] * 4`` on a one-card
machine, ``["cpu"] * 8`` in the tests, as the JAX tests force eight host
devices) could not run at all, and the reference is one process too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over named axes (``jax.sharding.Mesh``).

    ``devices`` is flat, ``prod(axis_sizes)`` long; a device may repeat.
    ``mesh.shape[axis]`` is the axis' size, as in JAX."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes, strict=True))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, every other axis at index 0 (where a
        runner that shards only over ``axis`` places its shards)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        ax = self.axis_names.index(axis)
        stride = math.prod(self.axis_sizes[ax + 1:])
        return tuple(self.devices[i * stride]
                     for i in range(self.axis_sizes[ax]))


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over the axes ``names`` (``jax.make_mesh``).

    Without ``devices`` it takes the first ``prod(shape)`` CUDA devices and
    raises if there are fewer.  ``devices`` given explicitly (strings or
    ``torch.device`` s, ``prod(shape)`` of them) may repeat one device:
    ``["cpu"] * 8``, or ``["cuda:0"] * 4`` on a one-card machine."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} CUDA devices, found "
                f"{have}: pass devices= to place shards explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(_device(d) for d in devices)
    return Mesh(devs, tuple(names), shape)


def shard_map(body: Callable, mesh: Mesh, axis: str) -> Callable[..., List]:
    """``run(*args)`` calls ``body(shard, device, *args)`` once for every
    device along ``axis``, in shard order, with that device current, and
    returns the bodies' results as a list."""
    devs = mesh.axis_devices(axis)

    def run(*args) -> List:
        outs = []
        for shard, dev in enumerate(devs):
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                outs.append(body(shard, dev, *args))
        return outs

    return run

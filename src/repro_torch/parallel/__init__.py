"""Device meshes for the port (counterpart of ``repro/parallel``).

:mod:`.compat` holds :class:`~.compat.Mesh`, :func:`~.compat.make_mesh`
and :func:`~.compat.shard_map`, the port's stand-ins for
``jax.sharding.Mesh``, ``jax.make_mesh`` and the ``shard_map`` shim that
the sharded runner (:mod:`repro_torch.mpc.secure_matmul`) uses.  The
training side: :mod:`.sharding` (the reference's logical-axis rules and
parameter specs), :mod:`.compressed` (the int8 gradient reduction with
error feedback) and :mod:`.fsdp` (how one rank of the multi-rank trainer
holds and reduces its leaves by those specs, over ``torch.distributed``).
"""
from .compat import Mesh, make_mesh, shard_map

__all__ = ["Mesh", "make_mesh", "shard_map"]

"""Device meshes for the port (counterpart of ``repro/parallel``).

:mod:`.compat` holds :class:`~.compat.Mesh`, :func:`~.compat.make_mesh`
and :func:`~.compat.shard_map`, the port's stand-ins for
``jax.sharding.Mesh``, ``jax.make_mesh`` and the ``shard_map`` shim that
the sharded runner (:mod:`repro_torch.mpc.secure_matmul`) uses.  The
training-side modules (``sharding.py``, ``compressed.py``) come with
multi-card training (ROADMAP queue 1, item 16): the one-card trainer
(:mod:`repro_torch.train.step`) uses neither.
"""
from .compat import Mesh, make_mesh, shard_map

__all__ = ["Mesh", "make_mesh", "shard_map"]

"""Execution backends for :class:`repro_torch.mpc.api.MPCSession`.

Port of ``repro/mpc/backends.py``.  A backend runs a list of coded block
products (``BlockOp``: protocol + field-domain ``m×m`` operands + key +
survivor mask) and returns one field-domain result, or a ``BlockFailure``,
per op, in order.  A block whose survivor mask falls below the decode
quorum becomes a ``BlockFailure`` in its slot and never takes down the
other blocks.

Only :class:`LocalBackend` is ported so far: every block through
``AGECMPCProtocol.run`` on the session's device.  The reference's
``sharded``, ``batched`` and ``remote`` backends raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Union

from .api import BlockFailure, BlockOp
from .errors import QuorumError
from .protocol import MODES

BlockResult = Union[Any, BlockFailure]  # a field-domain tensor, or a failure


class MPCBackend:
    """Backend interface: run blocks, optionally own attrition handling."""

    name = "abstract"
    # True when the backend tracks dead workers itself (elastic pools);
    # otherwise the session folds its dead set into each block's mask
    handles_attrition = False

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        raise NotImplementedError

    def fail(self, dead: frozenset) -> None:
        """Receive the session's cumulative dead-worker set (ids)."""


class LocalBackend(MPCBackend):
    """Single-process execution, one ``run`` per block (``mode`` =
    ``"fused"`` | ``"kernel"`` | ``"reference"``)."""

    name = "local"

    def __init__(self, *, mode: str = "fused"):
        if mode not in MODES:
            raise ValueError(
                f"unknown mode {mode!r}: expected fused|kernel|reference")
        self.mode = mode

    def run_blocks(self, ops: Sequence[BlockOp]) -> List[BlockResult]:
        outs: List[BlockResult] = []
        for op in ops:
            try:
                outs.append(op.proto.run(op.a, op.b, op.key,
                                         survivors=op.survivors,
                                         mode=self.mode))
            except QuorumError as e:  # below-threshold mask: isolate
                outs.append(BlockFailure(str(e)))
        return outs


BACKENDS = {"local": LocalBackend}

_NOT_PORTED = {
    "batched": "the batched engine slice (ROADMAP queue 1, item 7)",
    "sharded": "the sharded runner slice (ROADMAP queue 1, item 8)",
    "remote": "the transport slice (ROADMAP queue 1, item 9)",
}


def resolve_backend(backend: Union[str, MPCBackend],
                    **opts) -> MPCBackend:
    """A backend instance from a name (+ options) or a ready instance."""
    if isinstance(backend, MPCBackend):
        if opts:
            raise ValueError(
                f"backend options {sorted(opts)} ignored for an instance")
        return backend
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} comes with {_NOT_PORTED[backend]}")
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}: expected one of "
            f"{sorted(BACKENDS)} or an MPCBackend instance") from None
    return cls(**opts)

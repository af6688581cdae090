"""Structured survivor/quorum errors for the MPC stack (DESIGN.md §9).

The survivor checks used to be a mix of bare ``ValueError``/``RuntimeError``
raises scattered across ``api.validate_survivors``, ``planner.survivor_rows``
and the elastic/engine escalation paths, so callers could not tell "too few
survivors" from "malformed mask" without parsing message strings.  This
module is the one taxonomy they all raise from:

* :class:`QuorumError` — too few alive workers for a decode/serving quorum
  (a ``RuntimeError``, like the legacy raises, so ``except RuntimeError``
  call sites keep working).  Carries the spec, the required quorum, the
  alive count and the offending slots as attributes.
* :class:`MaskShapeError` — a malformed survivor mask or index set (wrong
  shape / arity).  Subclasses BOTH :class:`QuorumError` and ``ValueError``:
  legacy ``except ValueError`` callers still catch it, while
  ``except QuorumError`` catches the whole family.
* :class:`AdversaryBudgetError` — the Byzantine path's uniform "budget
  ``a`` exhausted" raise: more corrupted shares were detected than the
  spec's adversary budget tolerates (or error-correction failed within
  it).  A :class:`QuorumError`, so the engine's failure isolation treats
  it like any other unservable request.

Every constructor keyword is optional — the taxonomy adds context, it
never demands it — and all context lands on attributes (``spec``,
``quorum``, ``alive``, ``slots``) for programmatic handling.
"""
from __future__ import annotations

from typing import Optional, Tuple


class QuorumError(RuntimeError):
    """Too few alive workers for a required quorum.

    Attributes
    ----------
    spec   : the :class:`~repro.mpc.api.MPCSpec` being validated (or None)
    quorum : the required worker count (decode threshold, verified quorum,
             phase-2 N, …)
    alive  : how many workers were actually available
    slots  : the offending slot / device ids, when known
    """

    def __init__(self, message: str, *, spec=None,
                 quorum: Optional[int] = None, alive: Optional[int] = None,
                 slots=None):
        super().__init__(message)
        self.spec = spec
        self.quorum = None if quorum is None else int(quorum)
        self.alive = None if alive is None else int(alive)
        self.slots: Optional[Tuple[int, ...]] = (
            None if slots is None else tuple(int(s) for s in slots))


class MaskShapeError(QuorumError, ValueError):
    """A malformed survivor mask / index set (wrong shape or arity)."""


class AdversaryBudgetError(QuorumError):
    """More corrupted shares than the spec's adversary budget ``a``."""


class ShapeContractError(ValueError):
    """Operands violate a kernel/model shape contract.

    Raised where a bare ``assert`` used to guard operand shapes (inner
    dims of a matmul, head-count divisibility, required embeddings, …).
    A ``ValueError`` so generic callers keep working; distinct so the
    ``no-bare-assert`` analyzer rule (:mod:`repro.analysis.jitlint`) has a
    structured replacement to point at.  Carries the offending shapes on
    ``shapes`` when the raiser knows them.
    """

    def __init__(self, message: str, *, shapes=None):
        super().__init__(message)
        self.shapes = None if shapes is None else tuple(shapes)


class InvariantError(RuntimeError):
    """A proven protocol/module invariant failed at runtime.

    The theorem-backed checks (degree-set conditions C1–C3, Theorem 1
    decodability, the ``acc_window`` module contract, sanity checks on
    generated output) used to be bare ``assert``s — stripped under
    ``python -O`` and indistinguishable from plain bugs.  They raise this
    instead; the static prover (:mod:`repro.analysis.invariants`) checks
    the same inequalities over the whole tuner-reachable space at analysis
    time, so hitting one at runtime means the environment, not the math,
    broke.
    """

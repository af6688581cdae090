"""Static-analysis subsystem of the port: overflow certificates, lint of
device-stream hazards, invariant prover.

Port of ``repro/analysis``.  Three passes, one CLI
(``python -m repro_torch.analysis``):

* :mod:`.overflow` — interval proofs, over the integer-interval domain of
  :mod:`.intervals`, that no intermediate of the port's field pipeline
  (the barrett ops, Montgomery tables, the assemble refold, and every
  accumulator of the CUDA mod-p kernels) leaves its container for any
  ``(p, scheme, s, t, λ, m)`` the port's tuner can emit.  Exports
  :func:`~.overflow.certified_window` and :func:`~.overflow.
  certified_k_run`, the machine-checked fold cadences the kernels
  consume.
* :mod:`.jitlint` — AST lint for hazards on the card's hot paths: host
  syncs, allocation shapes that vary per loop iteration, bare
  ``assert``s.  ``# analysis: allow(<rule>): reason`` suppresses a site.
* :mod:`.invariants` — prover for the protocol inequalities (``N ≥
  t²+z``, ``N ≥ t²+z+2a``, C1–C3, Theorem 1) over the port's
  spec-construction paths.
"""
from .intervals import Interval
from .overflow import (
    certified_k_run,
    certified_window,
    verify_field_pipeline,
    verify_spec_space,
)
from .report import Finding, load_baseline, write_baseline

__all__ = [
    "Interval",
    "Finding",
    "certified_k_run",
    "certified_window",
    "load_baseline",
    "verify_field_pipeline",
    "verify_spec_space",
    "write_baseline",
]

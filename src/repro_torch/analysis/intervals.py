"""Exact integer-interval domain for the overflow proofs (DESIGN.md §12).

The field pipeline's intermediates are integers flowing through int64,
uint64 and f64 containers.  Python ints are unbounded, so an interval
``[lo, hi]`` tracks each intermediate's exact reachable range under the
abstract transfer functions below — no widening, no approximation beyond
the usual independent-bounds product rule.  A value *provably fits* a
container when its whole interval does:

* ``fits_int64``        — ``−2⁶³ ≤ lo`` and ``hi < 2⁶³`` (the accumulator
  contract of :func:`repro.mpc.field.acc_window`);
* ``fits_uint64``       — ``0 ≤ lo`` and ``hi < 2⁶⁴`` (Montgomery REDC);
* ``fits_f64_mantissa`` — ``|lo|, |hi| ≤ 2⁵³`` (float64 represents every
  integer up to 2⁵³ exactly: the limb-GEMM partial-sum contract).

Transfer functions are the smallest sound ones for the operations the
pipeline actually performs: ``+``, ``−``, ``·``, sum of ``n`` independent
draws, right shift and low-bit masking on non-negative ranges.
"""
from __future__ import annotations

import dataclasses

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1
UINT64_MAX = 2**64 - 1
F64_EXACT = 2**53


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval ``[lo, hi]`` (exact Python ints)."""

    lo: int
    hi: int

    def __post_init__(self):
        if not (isinstance(self.lo, int) and isinstance(self.hi, int)):
            raise TypeError(f"interval bounds must be ints: {self!r}")
        if self.lo > self.hi:
            raise ValueError(f"empty interval: [{self.lo}, {self.hi}]")

    # ------------------------------------------------------------ factories
    @classmethod
    def const(cls, v: int) -> "Interval":
        return cls(int(v), int(v))

    @classmethod
    def residue(cls, p: int) -> "Interval":
        """A field element: ``[0, p−1]``."""
        return cls(0, int(p) - 1)

    @classmethod
    def nonneg_below(cls, bound: int) -> "Interval":
        """``[0, bound−1]`` — e.g. the ``x < 2⁶³`` Barrett input domain."""
        return cls(0, int(bound) - 1)

    # ------------------------------------------------------------ transfer
    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __sub__(self, other: "Interval") -> "Interval":
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def __mul__(self, other: "Interval") -> "Interval":
        cs = (self.lo * other.lo, self.lo * other.hi,
              self.hi * other.lo, self.hi * other.hi)
        return Interval(min(cs), max(cs))

    def scale(self, c: int) -> "Interval":
        return self * Interval.const(c)

    def sum_n(self, n: int) -> "Interval":
        """Sum of ``n`` independent draws from this interval (n ≥ 0)."""
        if n < 0:
            raise ValueError(f"need n >= 0, got {n}")
        return Interval(self.lo * n, self.hi * n)

    def rshift(self, bits: int) -> "Interval":
        """``x >> bits`` for non-negative ranges (arithmetic = logical)."""
        if self.lo < 0:
            raise ValueError("rshift is only modeled for non-negative ranges")
        return Interval(self.lo >> bits, self.hi >> bits)

    def mask_low(self, bits: int) -> "Interval":
        """``x & (2^bits − 1)`` for non-negative ranges.

        Exact when the range covers a full mask period or sits inside one;
        otherwise the sound ``[0, 2^bits − 1]`` envelope.
        """
        if self.lo < 0:
            raise ValueError("mask_low is only modeled for non-negative ranges")
        m = (1 << bits) - 1
        if (self.lo >> bits) == (self.hi >> bits):
            return Interval(self.lo & m, self.hi & m)
        return Interval(0, min(self.hi, m))

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    # ----------------------------------------------------------- predicates
    @property
    def fits_int64(self) -> bool:
        return INT64_MIN <= self.lo and self.hi <= INT64_MAX

    @property
    def fits_uint64(self) -> bool:
        return 0 <= self.lo and self.hi <= UINT64_MAX

    @property
    def fits_f64_mantissa(self) -> bool:
        return abs(self.lo) <= F64_EXACT and abs(self.hi) <= F64_EXACT

    def within(self, lo: int, hi: int) -> bool:
        return lo <= self.lo and self.hi <= hi

    def __repr__(self) -> str:  # compact in proof failure messages
        return f"[{self.lo}, {self.hi}]"

"""Vectorized Montgomery arithmetic over F_p for NumPy int64/uint64 arrays.

Plan construction (Vandermonde tables, Gauss–Jordan inverses — see
:mod:`repro.mpc.lagrange`) used to run on Python-object arrays: exact but
O(N³) *interpreted* big-int operations.  Every residue here fits 31 bits, so
the whole pipeline vectorizes over machine words.  Montgomery's REDC keeps
the inner loop division-free: with ``R = 2³²`` and ``p' = −p⁻¹ mod R``,

    REDC(T) = (T + ((T mod R)·p' mod R)·p) / R      (an exact shift)

maps ``T = a·b < p·R`` to ``a·b·R⁻¹ mod p`` using two multiplies, one add
and one shift per element — all uint64, no ``%`` in the hot path.  Values
are kept in the Montgomery domain (``ā = a·R mod p``) across repeated
multiplications (exponentiation ladders, elimination sweeps) and converted
back once at the end.

Requires ``p`` odd and ``p < 2³¹`` (so ``T + m·p < 2⁶⁴`` never wraps);
both supported protocol primes qualify.
"""
from __future__ import annotations

import functools

import numpy as np

_R_BITS = 32
_R = 1 << _R_BITS
_MASK = np.uint64(_R - 1)
_SHIFT = np.uint64(_R_BITS)


class MontgomeryCtx:
    """Montgomery context for one prime ``p < 2³¹`` (vectorized uint64 ops)."""

    def __init__(self, p: int):
        if p % 2 == 0 or not (2 < p < 2**31):
            raise ValueError(f"need an odd prime < 2^31, got {p}")
        self.p = p
        self._p64 = np.uint64(p)
        # p' = -p^{-1} mod R  and  R² mod p (for the to-Montgomery map)
        self.pinv = np.uint64((-pow(p, -1, _R)) % _R)
        self.r2 = np.uint64((_R * _R) % p)
        self.one = np.uint64(_R % p)  # 1 in the Montgomery domain

    # ------------------------------------------------------------------ core
    def redc(self, t: np.ndarray) -> np.ndarray:
        """REDC(T) = T·R⁻¹ mod p for uint64 ``T < p·R``."""
        # analysis: allow(host-sync): host-side numpy tables
        t = np.asarray(t, np.uint64)
        m = ((t & _MASK) * self.pinv) & _MASK
        out = (t + m * self._p64) >> _SHIFT
        # out < 2p: one conditional subtract (bool·p avoids wraparound)
        return out - self._p64 * (out >= self._p64)

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Product in the Montgomery domain (inputs/outputs < p, uint64)."""
        # analysis: allow(host-sync): host-side numpy tables
        return self.redc(np.asarray(a, np.uint64) * np.asarray(b, np.uint64))

    def to_mont(self, a: np.ndarray) -> np.ndarray:
        # analysis: allow(host-sync): host-side numpy tables
        return self.mul(np.asarray(a, np.uint64) % self._p64, self.r2)

    def from_mont(self, a: np.ndarray) -> np.ndarray:
        # analysis: allow(host-sync): host-side numpy tables
        return self.redc(np.asarray(a, np.uint64))

    # ----------------------------------------------------------- conveniences
    def sub(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(a − b) mod p on uint64 residues (domain-agnostic)."""
        # analysis: allow(host-sync): host-side numpy tables
        a = np.asarray(a, np.uint64)
        # analysis: allow(host-sync): host-side numpy tables
        b = np.asarray(b, np.uint64)
        d = a + self._p64 - b          # residues < p, so never wraps
        return d - self._p64 * (d >= self._p64)

    def pow(self, bases: np.ndarray, exps: np.ndarray) -> np.ndarray:
        """Elementwise ``bases ** exps mod p`` (plain domain, broadcast).

        Square-and-multiply over the *bit positions* of ``exps``: O(log e)
        vectorized passes instead of per-element Python ``pow``.
        """
        # analysis: allow(host-sync): host-side numpy tables
        bases = np.asarray(bases, np.int64)
        # analysis: allow(host-sync): host-side numpy tables
        exps = np.asarray(exps, np.int64)
        if np.any(exps < 0):
            raise ValueError("negative exponents unsupported")
        bases, exps = np.broadcast_arrays(bases, exps)
        base_m = self.to_mont(bases.astype(np.uint64))
        res = np.full(bases.shape, self.one, np.uint64)
        max_bits = int(exps.max()).bit_length() if exps.size else 0
        for bit in range(max_bits):
            hit = ((exps >> bit) & 1).astype(bool)
            if hit.any():
                res = np.where(hit, self.mul(res, base_m), res)
            if bit + 1 < max_bits:
                base_m = self.mul(base_m, base_m)
        return self.from_mont(res).astype(np.int64)


@functools.lru_cache(maxsize=None)
def mont_ctx(p: int) -> MontgomeryCtx:
    return MontgomeryCtx(p)

"""Closed-form required-worker counts (paper Theorem 3 + Lemmas 4-7).

Two parallel implementations exist on purpose:

* this module -- the paper's *closed forms* (eq. (13)-(14), Υ₁..Υ₉ and the
  baseline formulas quoted in Appendix D), and
* :mod:`repro.core.age` -- exact degree-set enumeration.

``tests/test_theorem3.py`` proves them equal on a grid; the runtime framework
uses the enumeration (always correct by construction), the benchmarks report
both.
"""
from __future__ import annotations

from .age import optimal_age_code, polydot_code


# ----------------------------------------------------------------- Theorem 3
def gamma(s: int, t: int, z: int, lam: int) -> int:
    """Γ(λ) of eq. (14): |P(H(x))| for AGE with gap λ (t ≠ 1)."""
    if t == 1:
        raise ValueError("Γ is defined for t != 1; use n_age_cmpc")
    if not 0 <= lam <= z:
        raise ValueError(f"0 <= λ <= z violated: λ={lam}, z={z}")
    ts = t * s
    theta = ts + lam
    if lam == 0:
        if z > ts - s:
            return 2 * s * t * t + 2 * z - 1                       # Υ₁
        return s * t * t + 3 * s * t - 2 * s + t * (z - 1) + 1     # Υ₂
    if lam == z:
        return 2 * ts + (ts + z) * (t - 1) + 2 * z - 1             # Υ₃
    q = min((z - 1) // lam, t - 1)
    if z > ts:
        return (q + 2) * ts + theta * (t - 1) + 2 * z - 1          # Υ₄
    if ts < lam + s - 1:
        return 3 * ts + theta * (t - 1) + 2 * z - 1                # Υ₅
    if lam + s - 1 < z:
        if q * lam >= s:
            return 2 * ts + theta * (t - 1) + (q + 2) * z - q - 1  # Υ₆
        return (theta * (t + 1) + q * (z - 1) - 2 * lam + z + ts
                + min(0, z + s * (1 - t) - lam * q - 1))           # Υ₇
    # z <= λ + s - 1 <= ts
    if q * lam >= s:
        return (2 * ts + theta * (t - 1) + 3 * z
                + (lam + s - 1) * q - lam - s - 1)                 # Υ₈
    return (theta * (t + 1) + q * (s - 1) - 3 * lam + 3 * z - 1
            + min(0, ts - z + 1 + lam * q - s))                    # Υ₉


def n_age_cmpc(s: int, t: int, z: int, *, closed_form: bool = True) -> int:
    """``N_AGE-CMPC`` -- eq. (13): ``min_λ Γ(λ)`` (t≠1) or ``2s+2z-1`` (t=1)."""
    if t == 1:
        return 2 * s + 2 * z - 1
    if closed_form:
        return min(gamma(s, t, z, lam) for lam in range(z + 1))
    return optimal_age_code(s, t, z)[0].n_workers


def optimal_lambda(s: int, t: int, z: int) -> int:
    """λ* achieving ``min_λ Γ(λ)`` (largest λ on ties; Example 1 convention)."""
    if t == 1:
        return 0
    best_lam, best_n = 0, None
    for lam in range(z + 1):
        n = gamma(s, t, z, lam)
        if best_n is None or n <= best_n:
            best_lam, best_n = lam, n
    return best_lam


# ----------------------------------------------------------------- baselines
def n_entangled_cmpc(s: int, t: int, z: int) -> int:
    """Entangled-CMPC [14] (quoted in Lemma 4 / eq. (119))."""
    if t == 1:
        return 2 * s + 2 * z - 1
    ts = t * s
    if z > ts - s:
        return 2 * s * t * t + 2 * z - 1
    return s * t * t + 3 * s * t - 2 * s + t * (z - 1) + 1


def n_ssmm(s: int, t: int, z: int) -> int:
    """SSMM [15] Thm 1 (quoted in Lemma 5 / eq. (120)): ``(t+1)(ts+z) - 1``."""
    return (t + 1) * (t * s + z) - 1


def n_gcsa_na(s: int, t: int, z: int) -> int:
    """GCSA-NA [16] at batch size 1 (quoted in Lemma 6): ``2st² + 2z - 1``."""
    return 2 * s * t * t + 2 * z - 1


def n_polydot_cmpc(s: int, t: int, z: int, *, closed_form: bool = True) -> int:
    """PolyDot-CMPC [13].

    Closed forms are only quoted by this paper for the regions used in the
    Lemma 7 proof (eqs. (124), (125), (127), (129)-(131), (133)); outside them
    we fall back to degree-set enumeration of the PolyDot construction
    (validated against the quoted forms where both exist -- tests/test_lemmas).
    """
    if t == 1:
        return 2 * s + 2 * z - 1                                   # eq. (133)
    ts = t * s
    if closed_form:
        if s == 1:
            if z > t:
                return 2 * t * t + 2 * z - 1                       # eq. (125)
            return t * t + 2 * t + t * z - 1                       # eq. (129)
        if z > ts:
            q = min((z - 1) // (ts - t), t - 1)
            return (q + 2) * ts + (2 * ts - t) * (t - 1) + 2 * z - 1   # (124)
        if z > ts - t:
            return 2 * ts + (2 * ts - t) * (t - 1) + 3 * z - 1     # eq. (127)
    return polydot_code(s, t, z).n_workers


SCHEMES = {
    "age": n_age_cmpc,
    "entangled": n_entangled_cmpc,
    "ssmm": n_ssmm,
    "gcsa_na": n_gcsa_na,
    "polydot": n_polydot_cmpc,
}


def all_worker_counts(s: int, t: int, z: int) -> dict:
    return {name: fn(s, t, z) for name, fn in SCHEMES.items()}

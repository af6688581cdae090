"""Generalized-Vandermonde / Lagrange machinery over F_p.

Two solves appear in AGE-CMPC:

* **Phase 2** -- the workers jointly know N points of ``H(x)`` whose support
  is ``P(H)`` (|P(H)| = N).  The reconstruction weights ``r_n^{(i,l)}`` of
  eq. (9) are rows of the inverse of the generalized Vandermonde matrix
  ``V[n, m] = α_n^{P(H)_m}``.
* **Phase 3** -- the master interpolates ``I(x)`` (dense support, degree
  ``t²+z-1``) from any ``t²+z`` surviving workers: a plain Vandermonde solve
  restricted to the survivor α-set (this is the straggler-tolerance path).

Over a finite field a generalized Vandermonde matrix is not guaranteed
invertible for an arbitrary evaluation-point set; :func:`choose_alphas`
searches deterministically for a set making it invertible (a real systems
concern the paper's real-number intuition glosses over -- see DESIGN.md §3).

Performance (DESIGN.md §2): every residue fits 31 bits, so plan
construction runs on vectorized int64/uint64 NumPy with Montgomery REDC
multiplication (:mod:`repro.mpc.montgomery`) — no Python-object arrays in
the hot path.  The original interpreted implementations are kept as
``vandermonde_ref`` / ``inv_mod_ref``: they are the bit-exactness oracle
(``tests/test_fastpath.py``) and the baseline side of the plan-construction
speedup pair emitted by ``benchmarks/protocol_bench.py``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .field import Field, acc_window
from .montgomery import mont_ctx


# --------------------------------------------------------------- vectorized
def vandermonde(field: Field, alphas: Sequence[int],
                powers: Sequence[int]) -> np.ndarray:
    """V[n, m] = α_n ^ powers[m]  (mod p), int64 numpy.

    Vectorized square-and-multiply over the exponent bits (Montgomery
    domain): O(log max_power) array passes for the whole [N, M] table.
    """
    p = field.p
    # analysis: allow(host-sync): host-side numpy tables
    al = np.atleast_1d(np.asarray(alphas, dtype=np.int64)) % p
    # analysis: allow(host-sync): host-side numpy tables
    pw = np.atleast_1d(np.asarray(powers, dtype=np.int64))
    if p >= 2**31 or p % 2 == 0:  # outside the Montgomery ctx domain
        return vandermonde_ref(field, al, pw)
    ctx = mont_ctx(p)
    return ctx.pow(al[:, None], pw[None, :])


def power_table(field: Field, alphas: Sequence[int], max_pow: int) -> np.ndarray:
    """``T[n, e] = α_n^e`` for e = 0..max_pow (int64, [N, max_pow+1]).

    One Montgomery-domain running product: every Vandermonde table the
    planner needs (phase-1, G-mix, masks, decode) is a *column slice* of
    this, so plan construction pays for the exponentiation exactly once.
    """
    p = field.p
    # analysis: allow(host-sync): host-side numpy tables
    al = np.atleast_1d(np.asarray(alphas, dtype=np.int64)) % p
    if p >= 2**31 or p % 2 == 0:
        return vandermonde_ref(field, al, np.arange(max_pow + 1))
    ctx = mont_ctx(p)
    base = ctx.to_mont(al)
    cols = np.empty((max_pow + 1, len(al)), np.uint64)
    cols[0] = ctx.one
    for e in range(1, max_pow + 1):
        cols[e] = ctx.mul(cols[e - 1], base)
    return ctx.from_mont(cols.T).astype(np.int64)


def matmul_mod(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact ``(a @ b) mod p`` on int64 NumPy via chunk-then-fold.

    Same accumulation contract as the JAX side (``field.acc_window``): fold
    every ``window`` products so partial sums never overflow int64.
    """
    # analysis: allow(host-sync): host-side numpy tables
    a = np.asarray(a, np.int64) % p
    # analysis: allow(host-sync): host-side numpy tables
    b = np.asarray(b, np.int64) % p
    window = acc_window(p)
    k = a.shape[-1]
    out = np.zeros(a.shape[:-1] + b.shape[1:], np.int64)
    for lo in range(0, k, window):
        hi = min(lo + window, k)
        out = (out + a[..., lo:hi] @ b[lo:hi]) % p
    return out


def inv_mod(field: Field, mat: np.ndarray) -> np.ndarray:
    """Matrix inverse over F_p by Gauss-Jordan (vectorized row ops).

    Per column: one scalar Fermat inverse for the pivot, then a single
    vectorized outer-product elimination over int64 lanes (residues < p, so
    every product fits int64 with room for the subtract).  No object arrays
    and no interpreted inner loops — ~50-100× the original object-dtype
    sweep for N ≥ 17.
    """
    p = field.p
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"square matrix required, got {mat.shape}")
    if p >= 2**31:
        return inv_mod_ref(field, mat)  # products may overflow int64
    # augmented [A | I]: one array per row op instead of two
    aug = np.concatenate(
        # analysis: allow(host-sync): host-side numpy tables
        [np.asarray(mat, np.int64) % p, np.eye(n, dtype=np.int64)], axis=1)
    for col in range(n):
        nz = np.nonzero(aug[col:, col])[0]
        if nz.size == 0:
            raise np.linalg.LinAlgError(f"singular over F_{p} at column {col}")
        piv = col + int(nz[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        s = pow(int(aug[col, col]), p - 2, p)
        aug[col] = aug[col] * s % p
        # eliminate the column everywhere else in one vectorized sweep
        f = aug[:, col].copy()
        f[col] = 0
        aug = (aug - f[:, None] * aug[col][None, :]) % p
    return aug[:, n:]


def try_inverse(field: Field, mat: np.ndarray):
    """``inv_mod`` that returns ``None`` instead of raising on singular.

    Lets callers that need both the invertibility *check* and the inverse
    (α-set search + reconstruction weights) pay for one elimination only.
    """
    try:
        return inv_mod(field, mat)
    except np.linalg.LinAlgError:
        return None


# ---------------------------------------------------- interpreted references
def vandermonde_ref(field: Field, alphas: Sequence[int],
                    powers: Sequence[int]) -> np.ndarray:
    """Original per-element ``pow`` build (oracle / benchmark baseline)."""
    out = np.empty((len(alphas), len(powers)), dtype=np.int64)
    for i, a in enumerate(alphas):
        for j, e in enumerate(powers):
            out[i, j] = pow(int(a) % field.p, int(e), field.p)
    return out


def inv_mod_ref(field: Field, mat: np.ndarray) -> np.ndarray:
    """Original object-dtype Gauss-Jordan (oracle / benchmark baseline)."""
    p = field.p
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"square matrix required, got {mat.shape}")
    a = mat.astype(object) % p          # python ints: no overflow
    inv = np.eye(n, dtype=object)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r, col] % p != 0:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError(
                f"singular over F_{p} at column {col}"
            )
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        s = pow(int(a[col, col]), p - 2, p)
        a[col] = (a[col] * s) % p
        inv[col] = (inv[col] * s) % p
        for r in range(n):
            if r != col and a[r, col] % p != 0:
                f = int(a[r, col])
                a[r] = (a[r] - f * a[col]) % p
                inv[r] = (inv[r] - f * inv[col]) % p
    return inv.astype(np.int64)


# ------------------------------------------------------------------ shared
def is_invertible(field: Field, mat: np.ndarray) -> bool:
    try:
        inv_mod(field, mat)
        return True
    except np.linalg.LinAlgError:
        return False


# α-set search constants — shared by choose_alphas and the planner so the
# two can never drift: deterministic reseed stream, bounded retries, and a
# candidate pool capped so huge primes don't blow up the draw.
ALPHA_SEARCH_SEED = 0
ALPHA_SEARCH_TRIES = 64
ALPHA_POOL_LIMIT = 2**20


def choose_alphas_with_inverse(field: Field, n: int, powers: Sequence[int],
                               *, max_tries: int = ALPHA_SEARCH_TRIES,
                               vand_fn=None):
    """Pick N distinct non-zero α's with invertible generalized Vandermonde
    on ``powers`` and return ``(alphas, V⁻¹)`` — the check and the solve
    share one elimination.  ``vand_fn(field, cand, powers)`` overrides the
    table build (the planner slices a shared power table)."""
    build = vand_fn or vandermonde
    rng = np.random.default_rng(ALPHA_SEARCH_SEED)
    cand = np.arange(1, n + 1, dtype=np.int64)
    for attempt in range(max_tries):
        w = try_inverse(field, build(field, cand, powers))
        if w is not None:
            return cand, w
        cand = rng.choice(
            np.arange(1, min(field.p, ALPHA_POOL_LIMIT), dtype=np.int64),
            size=n, replace=False)
    raise RuntimeError(f"no invertible α-set found in {max_tries} tries")


def choose_alphas(field: Field, n: int, powers: Sequence[int],
                  *, max_tries: int = ALPHA_SEARCH_TRIES) -> np.ndarray:
    """Deterministically pick N distinct non-zero α's with invertible
    generalized Vandermonde on ``powers`` (paper sets α_n = n; we start there
    and re-seed on singularity)."""
    alphas, _ = choose_alphas_with_inverse(field, n, powers,
                                           max_tries=max_tries)
    return alphas


def reconstruction_weights(field: Field, alphas: Sequence[int],
                           powers: Sequence[int]) -> np.ndarray:
    """W[m, n]: coefficient of x^powers[m] = Σ_n W[m,n]·f(α_n)  (eq. (9))."""
    v = vandermonde(field, alphas, powers)
    return inv_mod(field, v).astype(np.int64)  # V^{-1}: [m, n]


def lagrange_coeff_rows(field: Field, alphas: Sequence[int], degree: int,
                        wanted: Sequence[int]) -> np.ndarray:
    """Phase-3 master decode: rows of V^{-1} for a *dense* polynomial of
    ``degree`` (support 0..degree) evaluated at ``alphas``
    (len == degree+1), restricted to the ``wanted`` coefficients."""
    if len(alphas) != degree + 1:
        raise ValueError(f"need exactly {degree+1} points, got {len(alphas)}")
    w = reconstruction_weights(field, alphas, list(range(degree + 1)))
    # analysis: allow(host-sync): host-side numpy tables
    return w[np.asarray(wanted, dtype=np.int64)]

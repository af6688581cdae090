"""Pseudo-Mersenne modular reduction and exact mod-p products in plain torch.

Port of ``repro/kernels/barrett.py``, bit for bit.  Both supported primes
are *pseudo-Mersenne*: ``p = 2^b − c`` with tiny ``c`` (``2²⁶ − 5`` and
``2³¹ − 1``), so the Barrett quotient step collapses to a multiply-shift
*fold*::

    x ≡ c · (x >> b) + (x & (2^b − 1))   (mod p)

A fixed handful of folds plus one conditional subtract reduces any
non-negative int64 (``x < 2⁶³``) to ``[0, p)`` with no integer division.
The CUDA kernels run the same fold as a ``__device__`` function
(``csrc/field.cuh``) with the fold count :func:`barrett_params` computes.

These ops are the plain versions of the kernels: the whole port's CPU path
and the second oracle the kernels are held against on the card.  They run
on CUDA tensors too, because CUDA has no int64 GEMM: :func:`matmul_limbs`
does the products as float64 GEMMs on integer limbs (exact below 2⁵³), and
:func:`matmul_plain` never reaches ``torch.matmul`` on int64 there.
"""
from __future__ import annotations

import functools

import torch

_MAX_INPUT_BITS = 63  # mod_p domain: 0 <= x < 2^63 (non-negative int64)


@functools.lru_cache(maxsize=None)
def barrett_params(p: int):
    """``(b, c, n_folds)`` for the pseudo-Mersenne fold, or ``None``.

    ``n_folds`` is the number of ``c·hi + lo`` folds after which the
    worst-case value is provably ``< 2p`` (so one conditional subtract
    finishes the reduction).  Returns ``None`` when the fold does not
    converge quickly (``c`` too large relative to ``2^b``).
    """
    if p < 3:
        return None
    b = p.bit_length()
    c = (1 << b) - p
    bound = (1 << _MAX_INPUT_BITS) - 1
    for n_folds in range(1, 8):
        bound = c * (bound >> b) + ((1 << b) - 1)
        if bound < 2 * p:
            return b, c, n_folds
    return None


def mod_p(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x mod p`` for non-negative int64 ``x < 2⁶³`` via multiply-shift."""
    params = barrett_params(p)
    if params is None:
        return torch.remainder(x, p)
    b, c, n_folds = params
    mask = (1 << b) - 1
    for _ in range(n_folds):
        x = c * (x >> b) + (x & mask)
    return torch.where(x >= p, x - p, x)


def matmul_limbs(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """Exact ``(a @ b) mod p`` through limb-decomposed float64 matmuls.

    Each operand splits into two ``lb``-bit limbs (``lb = ⌈bits(p)/2⌉``)
    and the product forms Karatsuba-style with three float64 GEMMs::

        a·b = hh·2^{2lb} + ((ah+al)(bh+bl) − hh − ll)·2^{lb} + ll

    Every partial sum is an integer ``< 2^{2lb+2}·K ≤ 2⁵³``, so the float
    pipeline is exact in any summation order (cuBLAS DGEMM included); the
    limbs recombine in int64 with Barrett folds.  Requires
    ``K ≤ 2^{53−2lb−2}``; larger K chunks.  Leading batch dims broadcast
    like :func:`torch.matmul`.
    """
    if p.bit_length() > 31:
        raise ValueError("limb recombination needs p < 2^31")
    lb = (p.bit_length() + 1) // 2
    k_max = 1 << (53 - (2 * lb + 2))
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    k = a.shape[-1]
    if k > k_max:  # fold exact-size chunks (never hit by protocol shapes)
        out = None
        for lo in range(0, k, k_max):
            part = matmul_limbs(a[..., lo:lo + k_max],
                                b[..., lo:lo + k_max, :], p=p)
            out = part if out is None else mod_p(out + part, p)
        return out
    mask = (1 << lb) - 1
    ah = (a >> lb).to(torch.float64)
    al = (a & mask).to(torch.float64)
    bh = (b >> lb).to(torch.float64)
    bl = (b & mask).to(torch.float64)
    hh = torch.matmul(ah, bh)
    ll = torch.matmul(al, bl)
    mid = torch.matmul(ah + al, bh + bl) - hh - ll
    hh = mod_p(hh.to(torch.int64), p)
    mid = mod_p(mid.to(torch.int64), p)
    s2 = (1 << (2 * lb)) % p
    s1 = (1 << lb) % p
    # hh·s2 + mid·s1 < 2·p² < 2⁶³; + (ll mod p) after one more fold
    return mod_p(mod_p(hh * s2 + mid * s1, p) + mod_p(ll.to(torch.int64), p),
                 p)


def check_window(p: int, window: int) -> None:
    """Refuse a fold window past the certificate
    (:func:`repro_torch.analysis.overflow.certified_window`, which equals
    :func:`repro_torch.mpc.field.acc_window`): that many raw products
    would wrap int64 and give a wrong product with no error."""
    # lazy: the analysis package imports the field, which imports this
    from ..analysis.overflow import certified_window

    cert = certified_window(p)
    if not 1 <= window <= cert:
        raise ValueError(
            f"window={window} is outside 1..{cert}, the certified "
            f"accumulation window of p={p} (acc_window): {window} raw "
            f"products can leave int64")


def matmul_folded(a: torch.Tensor, b: torch.Tensor, *, p: int,
                  window: int) -> torch.Tensor:
    """Exact ``(a @ b) mod p`` with chunk-then-fold int64 accumulation.

    Up to ``window`` products (:func:`repro_torch.mpc.field.acc_window`)
    are summed raw in int64, then folded with :func:`mod_p`.  Uses int64
    ``matmul``/``einsum``, so it is a CPU op (CUDA has no int64 GEMM).
    A ``window`` past the certified one raises ``ValueError``
    (:func:`check_window`).
    """
    check_window(p, window)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    k = a.shape[-1]
    if window <= 1 and k > 1:
        prods = mod_p(a[..., :, :, None] * b[..., None, :, :], p)
        return mod_p(prods.sum(dim=-2), p)
    if k <= window:
        return mod_p(torch.matmul(a, b), p)
    n_chunks = -(-k // window)
    pad = n_chunks * window - k
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a = a.reshape(*a.shape[:-1], n_chunks, window)
    b = b.reshape(*b.shape[:-2], n_chunks, window, b.shape[-1])
    part = mod_p(torch.einsum("...mcw,...cwn->...cmn", a, b), p)
    # n_chunks partial sums, each < p: the re-fold stays inside int64 for
    # any realistic K (n_chunks · p < 2⁶³ ⇔ K < window · 2⁶³/p).
    return mod_p(part.sum(dim=-3), p)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, p: int,
                 window: int) -> torch.Tensor:
    """The plain ``(a @ b) mod p`` dispatch, on any device.

    On the CPU it keeps the JAX stages' rule (``planner.py``'s ``mm``):
    limb GEMMs when ``K > 32``, chunk-then-fold int64 otherwise.  On a
    CUDA tensor it always takes the limb GEMMs: CUDA has no int64 matmul.
    Both branches are exact, so they agree bit for bit.  A ``window`` past
    the certified one raises ``ValueError`` on either branch.
    """
    check_window(p, window)
    if p.bit_length() <= 31 and (a.shape[-1] > 32 or a.device.type != "cpu"):
        return matmul_limbs(a, b, p=p)
    return matmul_folded(a, b, p=p, window=window)

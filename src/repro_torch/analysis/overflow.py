"""Overflow verifier: interval proofs over the port's field pipeline.

Port of ``repro/analysis/overflow.py``.  The port's integer arithmetic
runs in other containers than the Pallas kernels', so its obligations are
its own: each one replays one stage's schedule (container, cadence,
refold) in the interval domain of :mod:`.intervals` and proves that no
intermediate leaves its container.  The stages:

* the pseudo-Mersenne fold ``mod_p`` (``kernels/barrett.py`` and its
  device twin ``csrc/field.cuh:22-28``), over its domain ``x < 2⁶³``;
* Montgomery REDC (``mpc/montgomery.py``) and the assemble refold
  (``mpc/tiling.py``'s ``assemble``);
* the plain versions: ``barrett.matmul_folded``'s chunk-then-fold int64
  product and ``barrett.matmul_limbs``' f64 limb GEMMs (what
  ``Field.matmul`` runs on CUDA tensors);
* one obligation per accumulator of the CUDA mod-p kernels:
  ``modmatmul.cu``'s uint64 tiles and its split-K second pass,
  ``modmatmul_tc.cu``'s s32 limb diagonals and their Horner fold,
  ``modmatmul_skinny.cu``'s uint64 sums, block tree and second pass,
  ``polyeval.cu``'s uint64 lanes and ``ring_fold.cu``'s uint32 sum.

:func:`certified_window` and :func:`certified_k_run` derive the widest
provable fold cadences by bisection, never by reading
:func:`repro_torch.mpc.field.acc_window` or ``K_RUN_MAX``, which makes
the cross-checks in :func:`self_check` proofs rather than tautologies.
The kernels consume them: ``kernels/_build.fold_args`` refuses a window
that disagrees with the certificate, the tensor-core launch a K-run past
it, and ``barrett.matmul_folded`` any ``window=`` past it.
:func:`verify_spec_space` quantifies the obligations over every
``(scheme, s, t, λ, m)`` the port's tuner can emit for a prime.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, Optional

from ..mpc.field import P_DEFAULT, P_MERSENNE31
from .intervals import INT64_MAX, Interval

#: worker-budget ceiling used when quantifying over the tuner's space, far
#: above any closed-form N at the partition bound
SPEC_SPACE_BUDGET = 4096

#: mod_p's domain, host and device: any non-negative x < 2⁶³
MOD_P_BOUND = 1 << 63
#: the fold counts the CUDA launchers instantiate mod_p<NF> for (1..4)
MAX_FOLDS = 4
#: modmatmul_tc.cu:108, BK: the tensor-core kernel folds on 128-byte tiles
TC_K_TILE = 128
#: the s32 limb diagonals of modmatmul_tc.cu
S32_BOUND = 1 << 31
#: ring_fold.cu's payloads: elements below 2³¹ summed in uint32
U32_BOUND = 1 << 32


class OverflowProofError(AssertionError):
    """An interval proof obligation failed (a real overflow is reachable)."""


def _require(ok: bool, what: str, iv: Interval) -> None:
    if not ok:
        raise OverflowProofError(f"{what}: reachable range {iv!r}")


def _in_mod_p_domain(iv: Interval) -> bool:
    return iv.within(0, MOD_P_BOUND - 1)


def _kernel_constants() -> Dict[str, int]:
    """The launch constants the CUDA obligations replay, read from the
    wrappers (imported here, not at module import: the kernels package
    imports the field, and the import of this module stays cheap)."""
    from ..kernels import modmatmul as mm

    return {"limbs": mm.LIMBS, "k_run_max": mm.K_RUN_MAX,
            "fold_low": mm.TC_FOLD_LOW,
            "grid_z": mm.MAX_GRID_Z, "grid_x": mm.MAX_GRID_X,
            "skinny_threads": mm.SKINNY_THREADS}


# ------------------------------------------------------- the certificates
def _bisect(safe, start: int = 1) -> int:
    """The largest ``q ≥ start`` with ``safe(q)`` (monotone), or
    ``start`` when even that fails."""
    if not safe(start):
        return start
    lo, hi = start, 2 * start
    while safe(hi):
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if safe(mid) else (lo, mid)
    return lo


@functools.lru_cache(maxsize=None)
def certified_window(p: int) -> int:
    """Largest fold cadence provably safe for a uint64 / int64 accumulator.

    Proof obligation: an accumulator after a fold (``< p``) plus
    ``window`` raw products of residues stays inside ``mod_p``'s domain
    (``< 2⁶³``).  Derived by interval bisection, not by calling
    :func:`repro_torch.mpc.field.acc_window`, so :func:`self_check`'s
    agreement with the hand derivation is an independent confirmation.
    ``certified_window(2²⁶−5) == 2048``, ``certified_window(2³¹−1) == 2``;
    1 means a fold after every product.
    """
    if p < 2:
        raise ValueError(f"need a modulus >= 2, got {p}")
    acc = Interval.residue(p)
    prod = Interval.residue(p) * Interval.residue(p)
    return _bisect(lambda q: _in_mod_p_domain(acc + prod.sum_n(q)))


def _limb_diagonals(k_run: int, limbs: int):
    """Each diagonal ``D_d = Σ_{i+j=d} A_i @ B_j`` of 8-bit limbs over a
    run of ``k_run`` products, as intervals (d = 0 … 2·limbs − 2)."""
    limb = Interval(0, 255)
    out = []
    for d in range(2 * limbs - 1):
        pairs = sum(1 for i in range(limbs) if 0 <= d - i < limbs)
        out.append((limb * limb).sum_n(pairs * k_run))
    return out


@functools.lru_cache(maxsize=None)
def certified_k_run() -> int:
    """Longest K-run whose limb diagonals provably fit the s32
    accumulators of ``modmatmul_tc.cu`` (``acc[DIAGS][16]``, wgmma
    ``.s32.u8.u8``): every diagonal of the kernel's ``LIMBS`` 8-bit limbs
    a side stays below 2³¹.  Derived by bisection over
    :func:`_limb_diagonals`, never by reading ``K_RUN_MAX``; for 4 limbs
    it is 8256."""
    limbs = _kernel_constants()["limbs"]
    return _bisect(lambda k: all(d.within(0, S32_BOUND - 1)
                                 for d in _limb_diagonals(k, limbs)))


# ------------------------------------------------------ host-side stages
def prove_barrett_fold(p: int, n_folds: Optional[int] = None) -> None:
    """The pseudo-Mersenne fold reduces any ``x < 2⁶³`` to ``[0, p)``.

    Replays ``kernels/barrett.py``'s ``mod_p`` and its device twin
    ``mod_p<NF>`` (``csrc/field.cuh:22-28``) with the fold count the
    port's :func:`~repro_torch.kernels.barrett.barrett_params` computes
    (``n_folds`` overrides it, which is how a mutation is shown to fail):
    every ``c·(x>>b) + (x & mask)`` must fit int64 (and so uint64), the
    folds must reach ``< 2p``, the one conditional subtract must land in
    ``[0, p)``, and the count must be one the launchers instantiate
    (``NF ≤ 4``).
    """
    from ..kernels.barrett import barrett_params

    params = barrett_params(p)
    if params is None:
        return          # non-pseudo-Mersenne: mod_p falls back to `%`
    b, c, nf = params
    nf = nf if n_folds is None else n_folds
    if not 1 <= nf <= MAX_FOLDS:
        raise OverflowProofError(
            f"mod_p<NF> is instantiated for NF in 1..{MAX_FOLDS}, p={p} "
            f"needs {nf}")
    x = Interval.nonneg_below(MOD_P_BOUND)
    for _ in range(nf):
        hi_term = x.rshift(b).scale(c)
        _require(hi_term.fits_int64, f"Barrett c*(x>>b) overflows (p={p})",
                 hi_term)
        x = hi_term + x.mask_low(b)
        _require(x.fits_int64, f"Barrett fold sum overflows (p={p})", x)
    _require(x.hi < 2 * p,
             f"Barrett fold does not converge below 2p in {nf} folds "
             f"(p={p})", x)
    reduced = Interval(0, min(x.hi, p - 1)).union(
        Interval(0, x.hi - p) if x.hi >= p else Interval(0, 0))
    _require(reduced.within(0, p - 1),
             f"Barrett conditional subtract leaves [0, p) (p={p})", reduced)


def prove_montgomery(p: int) -> None:
    """REDC never wraps uint64 and its output fits one subtract.

    Mirrors ``mpc/montgomery.py``'s ``MontgomeryCtx.redc``: ``T = a·b``
    of residues (or ``a·R² mod p`` entering the domain), ``m < R``, and
    ``T + m·p`` must fit uint64; the shifted result must be ``< 2p``.
    """
    from ..mpc.montgomery import _R_BITS

    r = 1 << _R_BITS
    if p % 2 == 0 or not (2 < p < 2**31):
        raise OverflowProofError(f"Montgomery context needs odd p < 2^31, "
                                 f"got {p}")
    t = Interval.residue(p) * Interval.residue(p)
    m = Interval(0, r - 1)
    lifted = t + m.scale(p)
    _require(lifted.fits_uint64,
             f"REDC T + m*p wraps uint64 (p={p})", lifted)
    out = lifted.rshift(_R_BITS)
    _require(out.hi < 2 * p,
             f"REDC output needs more than one conditional subtract "
             f"(p={p})", out)


def prove_assemble(p: int, max_terms: int = 1 << 20) -> None:
    """Decode/assemble partial-sum refolds stay in int64.

    ``mpc/tiling.py``'s ``assemble`` adds ``gk`` block outputs (each
    ``< p``) with a remainder after each; the survivor-decode row mixes
    sum residues raw.  ``max_terms`` residues summed raw covers both with
    ~2⁴³ of slack for either prime.
    """
    total = Interval.residue(p).sum_n(max_terms)
    _require(total.fits_int64,
             f"assemble refold of {max_terms} residues overflows int64 "
             f"(p={p})", total)


def prove_matmul_folded(p: int, window: int, n_chunks: int = 1) -> None:
    """``barrett.matmul_folded``: int64 ``matmul``/``einsum`` of at most
    ``window`` raw products, ``mod_p``, then ``n_chunks`` residues summed
    and folded once (a window of 1 folds every product and sums K
    residues, which ``n_chunks`` counts)."""
    if window < 1:
        raise ValueError(f"need window >= 1, got {window}")
    prod = Interval.residue(p) * Interval.residue(p)
    chain = prod.sum_n(window)
    _require(_in_mod_p_domain(chain),
             f"matmul_folded: {window} raw products leave mod_p's domain "
             f"(p={p}, certified window {certified_window(p)})", chain)
    refold = Interval.residue(p).sum_n(max(1, n_chunks))
    _require(_in_mod_p_domain(refold),
             f"matmul_folded: {n_chunks} chunk residues leave mod_p's "
             f"domain (p={p})", refold)


def limb_k_max(p: int) -> int:
    """The chunk ``barrett.matmul_limbs`` cuts K into: ``2^{53−2lb−2}``
    with ``lb = ⌈bits(p)/2⌉``."""
    lb = (p.bit_length() + 1) // 2
    return 1 << (53 - (2 * lb + 2))


def prove_limb_gemm(p: int, k: int, *, k_max: Optional[int] = None) -> None:
    """``barrett.matmul_limbs``' f64 limb GEMMs are mantissa-exact.

    Replays its schedule at inner dimension ``k``: K is cut into chunks of
    at most ``k_max`` (default :func:`limb_k_max`; passing a wider one is
    how a mutation is shown to fail), each chunk runs three f64 GEMMs of
    ``lb``-bit limbs whose partial sums must stay ≤ 2⁵³, the middle term
    ``(ah+al)(bh+bl) − hh − ll`` must be a non-negative int64, the
    recombination ``hh·s2 + mid·s1`` of folded terms must fit int64, and
    ``mod_p(out + part)`` joins the chunks.
    """
    if p.bit_length() > 31:
        raise OverflowProofError(
            f"limb recombination needs p < 2^31, got {p}")
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    k_max = limb_k_max(p) if k_max is None else k_max
    chunk = min(k, k_max)
    lb = (p.bit_length() + 1) // 2
    hi_limb = Interval(0, (p - 1) >> lb)
    lo_limb = Interval(0, min(p - 1, (1 << lb) - 1))
    hh = (hi_limb * hi_limb).sum_n(chunk)
    ll = (lo_limb * lo_limb).sum_n(chunk)
    mid_sum = ((hi_limb + lo_limb) * (hi_limb + lo_limb)).sum_n(chunk)
    for name, iv in (("hh", hh), ("ll", ll), ("(ah+al)(bh+bl)", mid_sum)):
        _require(iv.fits_f64_mantissa,
                 f"limb GEMM partial {name} exceeds the f64 mantissa at a "
                 f"chunk of K={chunk} (p={p})", iv)
    mid_true = (hi_limb * lo_limb + lo_limb * hi_limb).sum_n(chunk)
    _require(_in_mod_p_domain(mid_true),
             f"limb GEMM middle term leaves mod_p's domain at K={chunk} "
             f"(p={p})", mid_true)
    recomb = (Interval.residue(p) * Interval.residue(p)
              + Interval.residue(p) * Interval.residue(p))
    _require(_in_mod_p_domain(recomb),
             f"limb recombination hh*s2 + mid*s1 overflows int64 (p={p})",
             recomb)
    joined = Interval.residue(p) + Interval.residue(p)
    _require(_in_mod_p_domain(joined), "limb chunk join leaves int64", joined)


# ------------------------------------------------ CUDA kernel accumulators
def _window_chain(p: int, window: int, where: str) -> None:
    """An accumulator after a fold (``< p``) plus ``window`` raw products
    must stay in ``mod_p``'s domain before the next fold."""
    if window < 1:
        raise ValueError(f"need window >= 1, got {window}")
    chain = Interval.residue(p) + (Interval.residue(p)
                                   * Interval.residue(p)).sum_n(window)
    _require(_in_mod_p_domain(chain),
             f"{where}: a fold every {window} products leaves mod_p's "
             f"domain (p={p}, certified window {certified_window(p)})",
             chain)


def prove_cuda_core(p: int, window: int) -> None:
    """``csrc/modmatmul.cu:94-148`` (``modmatmul_kernel``): each thread's
    4x4 uint64 micro-tile accumulates at most ``window`` 32x32→64-bit
    products (``since`` counts them across the 32-deep K tiles) and folds
    with ``mod_p<NF>``; a last fold before the store."""
    _window_chain(p, window, "modmatmul.cu uint64 tile")


def prove_sum_splits(p: int, splits: Optional[int] = None) -> None:
    """``csrc/modmatmul.cu:165-172`` (``sum_splits_kernel``): the split-K
    partials, each ``< p``, summed in uint64 and folded once.  The launcher
    admits ``W·splits ≤ 65535`` (``MAX_GRID_Z``, ``modmatmul.cu:198-200``),
    so the obligation is proven at that many partials and refuses a count
    the kernel cannot be launched with."""
    grid_z = _kernel_constants()["grid_z"]
    splits = grid_z if splits is None else splits
    total = Interval.residue(p).sum_n(splits)
    if not 1 <= splits <= grid_z:
        raise OverflowProofError(
            f"sum_splits_kernel: {splits} partials is outside the launch "
            f"domain 1..{grid_z} (gridDim.z) this proof covers: reachable "
            f"range {total!r}")
    _require(_in_mod_p_domain(total),
             f"sum_splits_kernel: {splits} partials leave mod_p's domain "
             f"(p={p})", total)


def prove_tensor_core(p: int, k_run: Optional[int] = None) -> None:
    """``csrc/modmatmul_tc.cu``'s ``horner``, ``fold_run`` and epilogue
    (the tensor-core instance): every element splits into 4 unsigned 8-bit
    limbs, each diagonal ``D_d`` accumulates in s32 over a run of ``k_run``
    products (default the kernel's cadence ``K_RUN = ⌊K_RUN_MAX/128⌋·128``),
    and the run folds by Horner over the diagonals in uint64 with two
    reductions: ``x = D_6``, ``x ← (x << 8) + D_d`` for d = 5 … 2 (``d ≥
    FOLD_LOW``), ``x ← mod_p(x)``, ``x ← (x << 8) + D_d`` for d = 1, 0, then
    ``R ← mod_p(x + R)``.  Each diagonal must stay below 2³¹ and every
    value handed to ``mod_p`` inside its domain."""
    const = _kernel_constants()
    if k_run is None:
        k_run = (const["k_run_max"] // TC_K_TILE) * TC_K_TILE
    if k_run < 1:
        raise ValueError(f"need k_run >= 1, got {k_run}")
    diags = _limb_diagonals(k_run, const["limbs"])
    for d, iv in enumerate(diags):
        _require(iv.within(0, S32_BOUND - 1),
                 f"modmatmul_tc.cu diagonal D_{d} leaves s32 over a K-run "
                 f"of {k_run} (certified {certified_k_run()})", iv)
    low = const["fold_low"]
    x = diags[-1]
    for d in range(len(diags) - 2, -1, -1):
        if d == low - 1:
            _require(_in_mod_p_domain(x),
                     f"modmatmul_tc.cu horner: the high diagonals D_6 .. "
                     f"D_{low} leave mod_p's domain (p={p})", x)
            x = Interval.residue(p)
        x = x.scale(256) + diags[d]
    total = x + Interval.residue(p)
    _require(_in_mod_p_domain(total),
             f"modmatmul_tc.cu fold: mod_p(high) 2^{8 * low} + low + R "
             f"leaves mod_p's domain (p={p})", total)


def prove_skinny(p: int, window: int, blocks: Optional[int] = None) -> None:
    """``csrc/modmatmul_skinny.cu``: each thread's uint64 sums take at most
    ``window`` products between folds (``since + STEP > window``, lines
    75-118); at the end each is folded below p, summed across the warp by
    shuffles and across the block's warps in shared memory (256 residues,
    lines 127-142) and folded; ``sum_partials_kernel`` (lines 149-156)
    adds the ``blocks`` = G partials, G at most ``skinny_blocks``'
    ``MAX_GRID_X``."""
    const = _kernel_constants()
    _window_chain(p, window, "modmatmul_skinny.cu uint64 sum")
    tree = Interval.residue(p).sum_n(const["skinny_threads"])
    _require(_in_mod_p_domain(tree),
             f"modmatmul_skinny.cu block tree of {const['skinny_threads']} "
             f"residues leaves mod_p's domain (p={p})", tree)
    blocks = const["grid_x"] if blocks is None else blocks
    second = Interval.residue(p).sum_n(blocks)
    _require(_in_mod_p_domain(second),
             f"modmatmul_skinny.cu sum_partials_kernel: {blocks} partials "
             f"leave mod_p's domain (p={p})", second)


def prove_polyeval(p: int, window: int) -> None:
    """``csrc/polyeval.cu:227-268``: each consumer thread's 2R uint64
    lanes take at most ``window`` products (``++since == window``) before
    ``fold_all``; a last fold before the store.  Any K then stays exact."""
    _window_chain(p, window, "polyeval.cu uint64 lane")


def prove_ring_fold(p: int) -> None:
    """``csrc/ring_fold.cu:35-38``: ``a + b`` of two residues in the
    unsigned type of the payload (uint32 for the int32 wire) and one
    conditional subtract lands in ``[0, p)``."""
    s = Interval.residue(p) + Interval.residue(p)
    _require(s.within(0, U32_BOUND - 1),
             f"ring_fold.cu: a + b wraps uint32 (p={p})", s)
    out = Interval(0, max(min(s.hi, p - 1), s.hi - p))
    _require(out.within(0, p - 1),
             f"ring_fold.cu: one subtract leaves [0, p) (p={p})", out)


# ------------------------------------------------------- pipeline + space
def verify_field_pipeline(p: int, *, window: Optional[int] = None,
                          k_gemm: int = 256) -> Dict[str, int]:
    """Prove every stage of the port's field pipeline for one prime.

    ``window`` defaults to the kernels' (the certified one, capped at
    2³⁰ as ``fold_args`` caps it); passing a wider one is how the mutation
    test demonstrates rejection.  Returns the certified parameters and
    the obligation count.
    """
    cert = certified_window(p)
    win = min(cert, 2**30) if window is None else window
    chunk = limb_k_max(p)
    steps = (
        lambda: prove_barrett_fold(p),
        lambda: prove_montgomery(p),
        lambda: prove_assemble(p),
        lambda: prove_matmul_folded(p, win, -(-k_gemm // win)),
        lambda: prove_limb_gemm(p, k_gemm),
        # K past one chunk: whole chunks and their join
        lambda: prove_limb_gemm(p, chunk + 1),
        lambda: prove_cuda_core(p, win),
        lambda: prove_sum_splits(p),
        lambda: prove_tensor_core(p),
        lambda: prove_skinny(p, win),
        lambda: prove_polyeval(p, win),
        lambda: prove_ring_fold(p),
    )
    for step in steps:
        step()
    return {"p": p, "certified_window": cert, "verified_window": win,
            "certified_k_run": certified_k_run(), "obligations": len(steps)}


def _tuner_space(z_range: Iterable[int], a_range: Iterable[int],
                 budget: int):
    """Every ``(scheme, s, t, λ, N, z, a)`` the port's tuner can emit."""
    from ..mpc.autotune import MAX_PARTITION, _feasible

    schemes = ("age", "entangled", "polydot")
    axis = range(1, MAX_PARTITION + 1)
    for z in z_range:
        for a in a_range:
            for scheme, s, t, lam, n in _feasible(
                    budget, z, schemes, axis, axis, None, a):
                yield scheme, s, t, lam, n, z, a


def verify_spec_space(p: int, *, max_m: int = 256,
                      z_range: Optional[Iterable[int]] = None,
                      a_range: Iterable[int] = (0, 1, 2),
                      budget: int = SPEC_SPACE_BUDGET) -> Dict[str, int]:
    """Quantify the pipeline proof over the port's tuner-reachable space.

    For every family member ``mpc/autotune._feasible`` yields (all
    schemes, both partition axes to ``MAX_PARTITION``, every gap, every
    ``z`` in ``z_range``, every adversary budget in ``a_range``) and
    every block side ``m ≤ max_m`` with ``s|m`` and ``t|m``, prove:

    * the ``polyeval`` stages (shares and MAC tags at ``K = ts+z``, decode
      at ``K = t²+z+2a``, the exchange at ``K = N``): the kernel's lane
      chain at ``min(K, window)`` products, and the plain version
      (``matmul_plain``: limb GEMMs past K = 32, else ``matmul_folded``);
    * the phase-2 worker product at inner dim ``m/s``: the tensor-core
      K-run, the CUDA-core tile chain and its split-K pass, the skinny
      chain and tree, and both plain versions;
    * the MAC tags' ``[N, (m/t)²] @ [(m/t)², 1]`` through the skinny
      instance, and the sharded runner's ``ring_fold``.

    Returns counting stats; raises :class:`OverflowProofError` on the
    first unprovable config.
    """
    z_range = range(1, 9) if z_range is None else z_range
    cert = certified_window(p)
    win = min(cert, 2**30)
    k_run = certified_k_run()
    checks: set = set()         # distinct (kind, a, b) obligations
    configs = 0
    max_k_seen = 0

    def plain(k: int) -> None:
        if k > 32:
            checks.add(("limb", k, 0))
        else:
            checks.add(("folded", min(k, win), -(-k // win)))

    for scheme, s, t, lam, n, z, a in _tuner_space(z_range, a_range,
                                                   budget):
        configs += 1
        for k_terms in (t * s + z, t * t + z + 2 * a, n):
            max_k_seen = max(max_k_seen, k_terms)
            checks.add(("polyeval", min(k_terms, win), 0))
            plain(k_terms)
        step = s * t // math.gcd(s, t)
        m = step
        while m <= max_m:
            k_inner = m // s
            checks.add(("tensor_core", min(k_inner, k_run), 0))
            checks.add(("cuda_core", min(k_inner, win), 0))
            checks.add(("skinny", min(k_inner, win), 0))
            plain(k_inner)
            tags = (m // t) ** 2
            checks.add(("skinny", min(tags, win), 0))
            m += step
    fixed = (prove_barrett_fold, prove_montgomery, prove_assemble,
             prove_sum_splits, prove_ring_fold)
    for prove in fixed:
        prove(p)
    for kind, kk, chunks in sorted(checks):
        if kind == "polyeval":
            prove_polyeval(p, kk)
        elif kind == "tensor_core":
            prove_tensor_core(p, kk)
        elif kind == "cuda_core":
            prove_cuda_core(p, kk)
        elif kind == "skinny":
            prove_skinny(p, kk)
        elif kind == "folded":
            prove_matmul_folded(p, kk, chunks)
        else:
            prove_limb_gemm(p, kk)
    return {"p": p, "configs": configs, "distinct_proofs": len(checks) + len(fixed),
            "certified_window": cert, "certified_k_run": k_run,
            "max_inner_dim": max_k_seen}


def self_check() -> Dict[str, object]:
    """The analyzer's own consistency gate: the independently derived
    window must equal the hand-derived :func:`repro_torch.mpc.field.
    acc_window` on both shipped primes and the K-run must equal
    ``kernels/modmatmul.py``'s ``K_RUN_MAX``; one past each must be
    rejected."""
    from ..mpc.field import acc_window

    windows = {}
    for p in (P_DEFAULT, P_MERSENNE31):
        cert = certified_window(p)
        hand = acc_window(p)
        if cert != hand:
            raise OverflowProofError(
                f"certified_window({p})={cert} != acc_window={hand}: the "
                f"interval proof and the hand derivation disagree")
        over = Interval.residue(p) + (Interval.residue(p)
                                      * Interval.residue(p)).sum_n(cert + 1)
        if over.fits_int64:
            raise OverflowProofError(
                f"window {cert + 1} unexpectedly fits int64 for p={p}: the "
                f"window is not maximal (hi={over.hi} <= {INT64_MAX})")
        windows[p] = cert
    k_run = certified_k_run()
    hand_run = _kernel_constants()["k_run_max"]
    if k_run != hand_run:
        raise OverflowProofError(
            f"certified_k_run()={k_run} != K_RUN_MAX={hand_run}: the "
            f"interval proof and the kernel's constant disagree")
    try:
        prove_tensor_core(P_DEFAULT, k_run + 1)
    except OverflowProofError:
        pass
    else:
        raise OverflowProofError(
            f"a K-run of {k_run + 1} unexpectedly fits s32: the run is not "
            f"maximal")
    return {"window": windows, "k_run": k_run}

"""Cached protocol planning for AGE/Entangled/PolyDot-CMPC on torch.

Port of ``repro/mpc/planner.py``.  A *plan* is everything about one
``Y = AᵀB`` protocol instance that does not depend on the data: the
degree-set code, the evaluation points α_n, the reconstruction weights
``r_n^{(i,l)}`` (eq. (9)), the phase-1 Vandermonde tables, the phase-2
G-mix matrix and the default phase-3 decode rows.  The tables are built
with the same NumPy machinery and search constants as the reference, so
they are element-equal to it.

:func:`get_plan` memoizes plans process-wide, keyed by
``(scheme, s, t, z, lam, field.p, m)``.  Each plan also owns

* **device copies of its tables** (:meth:`ProtocolPlan.tables`), one set
  per device, made on first use;
* **staged programs** (:class:`ProtocolStages`, via
  :meth:`ProtocolPlan.stages`), one set per device: ``encode`` /
  ``worker_compute`` / ``exchange`` / ``decode`` plus the compositions
  ``front`` and ``fused``, and ``tags``;
* **batched stages** for the engine's waves (:meth:`ProtocolPlan.batched`:
  ``vfront``, ``vtags``, ``vdecode``), one launch per stage per wave
  whatever the number of lanes;
* **a survivor-solve LRU** (:meth:`ProtocolPlan.survivor_rows`,
  :meth:`ProtocolPlan.quorum_weights`), evicted least-recently-used at
  :data:`SOLVE_CACHE_SIZE` entries;
* **spare evaluation points** (:meth:`ProtocolPlan.pool_alphas`).

:func:`plan_from_arrays` builds a plan from another implementation's table
arrays, so the same tables can drive both.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import spans
from ..core.age import AGECode, GeneralizedPolyCode, optimal_age_code, polydot_code
from ..kernels import modmatmul as _kmm
from ..kernels import polyeval as _kpe
from .errors import MaskShapeError, ShapeContractError
from .field import Field, as_int64, generator, resolve_device
from .lagrange import (
    ALPHA_POOL_LIMIT,
    ALPHA_SEARCH_SEED,
    ALPHA_SEARCH_TRIES,
    choose_alphas_with_inverse,
    inv_mod,
    matmul_mod,
    power_table,
    try_inverse,
    vandermonde,
)

# (scheme, s, t, z, lam, p, m), plus the placement for pool specs
PlanKey = Tuple

# per-plan LRU capacity for survivor decode tables / quorum weights; each
# entry is a small int64 matrix (≤ N×N), so the cap bounds memory while
# keeping every straggler pattern a serving fleet realistically revisits hot
SOLVE_CACHE_SIZE = 128

_TABLES = ("vand_a", "vand_b", "g_mix_t", "vand_g_secret", "exchange",
           "decode_rows")


def _powers_a(code: GeneralizedPolyCode) -> np.ndarray:
    """Coded power for each (i, j) block of Aᵀ, flattened i-major."""
    pw = [j * code.alpha + i * code.beta
          for i in range(code.t) for j in range(code.s)]
    return np.fromiter(pw, dtype=np.int64, count=len(pw))


def _powers_b(code: GeneralizedPolyCode) -> np.ndarray:
    """Coded power for each (k, l) block of B, flattened k-major."""
    pw = [(code.s - 1 - k) * code.alpha + code.theta * l
          for k in range(code.s) for l in range(code.t)]
    return np.fromiter(pw, dtype=np.int64, count=len(pw))


def _sorted_powers(powers) -> np.ndarray:
    return np.fromiter(sorted(powers), dtype=np.int64, count=len(powers))


@dataclasses.dataclass(frozen=True)
class ProtocolStages:
    """Staged programs for one plan on one device.

    * ``encode(a, b, gen, secrets=None) -> (f_a, f_b)`` — phase-1 shares
      for all N workers; ``secrets=(sec_a, sec_b)`` injects the secret
      terms instead of drawing them from ``gen``;
    * ``worker_compute(f_a, f_b) -> h`` — every worker's ``H(α_n)``;
    * ``exchange(h, gen, mask_sum=None) -> i_pts`` — G-mix + aggregate
      mask, ``[N, m/t, m/t]``; ``mask_sum`` injects the mask;
    * ``decode(i_pts, idx, rows) -> y`` — phase 3 from the survivor index
      vector and decode rows (device tensors);
    * ``front(a, b, gen) -> i_pts`` — phases 1–2;
    * ``fused(a, b, gen) -> y`` — all three phases with the default rows;
    * ``tags(i_pts, gamma, offsets, rvec) -> [N]`` — per-share field MAC
      tags ``γ·⟨vec(I(α_n)), r⟩ + o_n mod p``.

    ``encode``, ``worker_compute``, ``exchange`` and ``decode`` also take
    operands with one leading lane dimension (``[B, m, m]``, injected
    secrets and masks ``[B, ...]``, ``[B, N, m/t, m/t]``): the batched
    stages of :meth:`ProtocolPlan.batched` are built from them.

    ``device`` is where the stages run; :meth:`timed` fences on it.
    ``encode``, ``worker_compute``, ``exchange`` and ``decode`` each run
    inside a span ``mpc.<stage>`` (:mod:`repro_torch.spans`), so the
    compositions and the timed copies carry them too.

    On a CUDA device every product is a kernel launch: ``worker_compute``
    goes to ``modmatmul_batched``, the skinny-K table products of
    ``encode``/``exchange``/``decode`` to ``polyeval`` (four launches per
    block: the exchange reads ``[h; mask]`` against the plan's
    ``[G-mix | mask table]`` in one, the fold inside the kernel, and decode
    reads the survivors' rows in place), and ``tags``'s product to
    ``modmatmul``'s ``skinny`` instance.  On the CPU the same wrappers run
    their plain versions, which keep the reference stages' dispatch rule.
    """

    encode: Callable
    worker_compute: Callable
    exchange: Callable
    decode: Callable
    front: Callable
    fused: Callable
    tags: Callable

    device: Optional[torch.device] = None

    def timed(self, recorder, *, plan: "ProtocolPlan" = None
              ) -> "ProtocolStages":
        """A copy whose stages time each call and feed the sink.

        ``recorder`` is duck-typed ``record(**kw)`` (e.g. :class:`repro_torch
        .sim.trace.PhaseRecorder`); each call gets ``phase`` (the stage
        name), wall ``us`` (fenced by ``torch.cuda.synchronize`` on the
        card; the CPU returns finished tensors), ``scalars`` (the stage's
        Cor. 8–10 work unit when ``plan`` is given, 0 otherwise),
        ``device=-1`` and ``klass=<scheme>``: a stage runs all N logical
        workers at once, so samples are fleet-aggregate, as in the
        reference.

        The fence stalls the host on every call: hand the *raw* stages to
        ``plan.runner`` builders and the engine's waves.
        """
        import time as _time

        counts = _stage_scalars(plan)
        klass = "stage" if plan is None else plan.scheme
        dev = self.device

        def wrap(name: str, fn: Callable) -> Callable:
            def timed_fn(*args, **kw):
                t0 = _time.perf_counter()
                out = fn(*args, **kw)
                if dev is not None and dev.type == "cuda":
                    # analysis: allow(host-sync): timed stages only, by design
                    torch.cuda.synchronize(dev)
                recorder.record(
                    device=-1, klass=klass, phase=name,
                    scalars=counts.get(name, 0),
                    us=(_time.perf_counter() - t0) * 1e6, lanes=1)
                return out
            return timed_fn

        return ProtocolStages(device=dev, **{
            name: wrap(name, getattr(self, name))
            for name in ("encode", "worker_compute", "exchange", "decode",
                         "front", "fused", "tags")})


def _stage_scalars(plan: Optional["ProtocolPlan"]) -> Dict[str, int]:
    """Per-stage scalar work units for one plan (the Cor. 8–10 counts the
    calibration layer normalizes measured wall time by): encode touches
    the 2N coded shares, worker_compute the N ξ-dominant block products,
    exchange the ζ all-pairs traffic, decode the quorum's ``(m/t)²``
    points; compositions sum their parts."""
    if plan is None:
        return {}
    n, s, t, z, m = (plan.n_workers, plan.s, plan.t, plan.z, plan.m)
    enc = 2 * n * (m * m) // (s * t)
    wc = int(n * m ** 3 / (s * t * t))
    exc = n * (n - 1) * m * m // (t * t)
    dec = (t * t + z) * (m // t) ** 2
    return {"encode": enc, "worker_compute": wc, "exchange": exc,
            "decode": dec, "front": enc + wc + exc,
            "fused": enc + wc + exc + dec, "tags": n * (m // t) ** 2}


def _build_stages(plan: "ProtocolPlan", device: torch.device) -> ProtocolStages:
    """The staged programs for one plan on one device.

    Phase-1 secrets and the phase-2 aggregate mask are drawn, in that
    order, from the caller's generator; the masks cancel identically in Y
    (``(V⁻¹V)[0:t², t²:t²+z] ≡ 0``), so Y never depends on the draws.
    """
    p, s, t, z, m = plan.p, plan.s, plan.t, plan.z, plan.m
    mt, ms = m // t, m // s
    n, t2z = plan.n_workers, plan.recovery_threshold
    field = plan.field
    tab = plan.tables(device)
    va, vb = tab["vand_a"], tab["vand_b"]
    mix, dec = tab["exchange"], tab["decode_rows"]
    default_idx = torch.arange(t2z, device=device)

    def table_mm(v, x):
        return _kpe.polyeval(v, x.contiguous(), p=p)

    @spans.spanned("mpc.encode")
    def encode(a, b, gen, *, secrets=None):
        lead = tuple(a.shape[:-2])           # () or (B,): the wave's lanes
        if secrets is None:
            sec_a = field.random(gen, (z, mt, ms))
            sec_b = field.random(gen, (z, ms, mt))
        else:
            sec_a, sec_b = (as_int64(x, device) for x in secrets)
        at = a.transpose(-1, -2).reshape(lead + (t, mt, s, ms))
        blocks_a = at.transpose(-3, -2).reshape(lead + (t * s, mt, ms))
        blocks_b = b.reshape(lead + (s, ms, t, mt)).transpose(-3, -2).reshape(
            lead + (s * t, ms, mt))
        terms_a = torch.cat([blocks_a, sec_a], dim=-3).reshape(
            lead + (-1, mt * ms))
        terms_b = torch.cat([blocks_b, sec_b], dim=-3).reshape(
            lead + (-1, ms * mt))
        f_a = table_mm(va, terms_a).reshape(lead + (n, mt, ms))
        f_b = table_mm(vb, terms_b).reshape(lead + (n, ms, mt))
        return f_a, f_b

    @spans.spanned("mpc.worker_compute")
    def worker_compute(f_a, f_b):
        # any leading shape: all N workers, a wave's lanes, or one remote
        # worker's [1, m/t, m/s] slice
        h = _kmm.modmatmul_batched(f_a.reshape(-1, mt, ms).contiguous(),
                                   f_b.reshape(-1, ms, mt).contiguous(), p=p)
        return h.reshape(tuple(f_a.shape[:-1]) + (mt,))

    @spans.spanned("mpc.exchange")
    def exchange(h, gen, *, mask_sum=None):
        lead = tuple(h.shape[:-3])
        mask_sum = (field.random(gen, (z, mt, mt)) if mask_sum is None
                    else as_int64(mask_sum, device))
        # G-mix and mask term in one product: [g_mix_t | vand_g_secret]
        # against the H-points stacked on the mask
        i_pts = _kpe.polyeval(
            mix, (h.reshape(lead + (n, mt * mt)).contiguous(),
                  mask_sum.reshape(lead + (z, mt * mt)).contiguous()), p=p)
        return i_pts.reshape(lead + (n, mt, mt))

    @spans.spanned("mpc.decode")
    def decode(i_pts, idx, rows):
        # the survivors' rows, gathered by the kernel
        lead = tuple(i_pts.shape[:-3])
        y_blocks = _kpe.polyeval(
            rows, i_pts.reshape(lead + (i_pts.shape[-3], mt * mt)).contiguous(),
            p=p, rows=idx)
        return _assemble(y_blocks, t, m)

    def front(a, b, gen):
        return exchange(worker_compute(*encode(a, b, gen)), gen)

    def fused(a, b, gen):
        return decode(front(a, b, gen), default_idx, dec)

    def tags(i_pts, gamma, offsets, rvec):
        # γ·v + o fits int64 for any p < 2³¹·⁵: v, γ < p ⇒ γ·v < 2⁶²
        v = _kmm.modmatmul(i_pts.reshape(n, mt * mt).contiguous(),
                           as_int64(rvec, device).reshape(mt * mt, 1),
                           p=p)[:, 0]
        return torch.remainder(gamma * v + offsets, p)

    return ProtocolStages(
        encode=encode, worker_compute=worker_compute, exchange=exchange,
        decode=decode, front=front, fused=fused, tags=tags, device=device)


def _assemble(y_blocks: torch.Tensor, t: int, m: int) -> torch.Tensor:
    """Decoded blocks ``[..., t², (m/t)²]`` (row u = i + t·l) as ``Y [...,
    m, m]``."""
    mt = m // t
    lead = tuple(y_blocks.shape[:-2])
    grid = y_blocks.reshape(lead + (t, t, mt, mt))            # [l, i, r, c]
    return grid.movedim(-4, -2).reshape(lead + (m, m))


def _build_batched(plan: "ProtocolPlan", kind: str,
                   device: torch.device) -> Callable:
    """One batched stage of the engine's waves, on ``device``.

    * ``vfront(a [B,m,m], b [B,m,m], keys) -> i_pts [B, N, m/t, m/t]``:
      lane b draws its secrets and mask from its own key's generator, in
      the order ``front`` does, so a request's I-points do not depend on
      the wave it lands in.  Three ``polyeval`` launches (encode A, encode
      B, the exchange) and one ``modmatmul_batched`` at W = B·N per wave.
    * ``vtags(i_pts, gamma [B], offsets [B,N], rvec [B,(m/t)²]) -> [B, N]``:
      one skinny ``modmatmul_batched`` launch (W = B) and the ``γ·v + o``
      epilogue on ``[B, N]``.
    * ``vdecode(i_pts [B,...], idx, rows, lanes=None) -> y [B', m, m]``:
      one ``polyeval`` launch for the lanes of one survivor pattern, all B
      (``lanes=None``) or those a device index ``lanes`` names.
    """
    p, z, m, t, s = plan.p, plan.z, plan.m, plan.t, plan.s
    mt, ms, n = m // t, m // s, plan.n_workers
    stages = plan.stages(device)

    def vfront(a, b, keys):
        lanes = a.shape[0]
        sec_a = torch.empty((lanes, z, mt, ms), dtype=torch.int64,
                            device=device)
        sec_b = torch.empty((lanes, z, ms, mt), dtype=torch.int64,
                            device=device)
        mask = torch.empty((lanes, z, mt, mt), dtype=torch.int64,
                           device=device)
        for i, key in enumerate(keys):
            gen = generator(key, device)
            for out in (sec_a[i], sec_b[i], mask[i]):   # front's draw order
                torch.randint(0, p, out.shape, generator=gen, out=out)
        f_a, f_b = stages.encode(a, b, None, secrets=(sec_a, sec_b))
        return stages.exchange(stages.worker_compute(f_a, f_b), None,
                               mask_sum=mask)

    def vtags(i_pts, gamma, offsets, rvec):
        lanes = i_pts.shape[0]
        v = _kmm.modmatmul_batched(
            i_pts.reshape(lanes, n, mt * mt).contiguous(),
            rvec.reshape(lanes, mt * mt, 1).contiguous(), p=p)[..., 0]
        return torch.remainder(gamma[:, None] * v + offsets, p)

    def vdecode(i_pts, idx, rows, lanes=None):
        if lanes is None:
            return stages.decode(i_pts, idx, rows)
        flat = i_pts.reshape(-1, mt * mt)
        per_lane = (lanes[:, None] * i_pts.shape[1] + idx[None, :]).contiguous()
        return _assemble(_kpe.polyeval(rows, flat, p=p, rows=per_lane), t, m)

    return {"vfront": vfront, "vtags": vtags, "vdecode": vdecode}[kind]


@dataclasses.dataclass(eq=False)  # identity semantics (ndarray fields;
class ProtocolPlan:               # the cache's contract is `is`, not `==`)
    """Data-independent tables for one protocol instance (int64 numpy)."""

    scheme: str
    s: int
    t: int
    z: int
    m: int
    p: int
    code: GeneralizedPolyCode
    alphas: np.ndarray          # [N] evaluation points
    powers_h: np.ndarray        # [N] sorted support of H(x)
    r_coeffs: np.ndarray        # [t², N]  eq. (9) rows, u = i + t·l
    vand_a: np.ndarray          # [N, ts+z] phase-1 F_A table
    vand_b: np.ndarray          # [N, ts+z] phase-1 F_B table
    g_mix: np.ndarray           # [N, N']  phase-2 H→G mixing scalars
    vand_g_secret: np.ndarray   # [N, z]   phase-2 mask table
    decode_rows: np.ndarray     # [t², t²+z] default (all-alive) decode rows

    # lazily-attached runners (stage sets per device), shared by every
    # protocol instance that resolves to this plan
    _runners: Dict[object, Callable] = dataclasses.field(
        default_factory=dict, repr=False)
    # re-entrant: building a device's stages fetches its tables, which
    # are themselves a runner of this plan
    _runner_lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False)
    _solve_cache: "OrderedDict" = dataclasses.field(
        default_factory=OrderedDict, repr=False)
    _solve_hits: int = dataclasses.field(default=0, repr=False)
    _solve_misses: int = dataclasses.field(default=0, repr=False)
    _pool_alphas: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict, repr=False)
    _field: Optional[Field] = dataclasses.field(default=None, repr=False)

    @property
    def n_workers(self) -> int:
        return len(self.alphas)

    @property
    def recovery_threshold(self) -> int:
        return self.t * self.t + self.z

    @property
    def field(self) -> Field:
        """A ``Field`` over this plan's prime (modular solves only)."""
        f = self._field
        if f is None:
            f = self._field = Field(self.p)
        return f

    def runner(self, kind, build: Callable[[], Callable]) -> Callable:
        """Get-or-build a runner attached to this plan (locked, built once)."""
        fn = self._runners.get(kind)
        if fn is None:
            with self._runner_lock:
                fn = self._runners.get(kind)
                if fn is None:
                    fn = self._runners[kind] = build()
        return fn

    def tables(self, device=None) -> Dict[str, torch.Tensor]:
        """The stage tables as int64 tensors on ``device`` (copied once per
        device): ``vand_a``, ``vand_b``, ``g_mix_t`` (the G-mix transposed,
        ``[N', N]``), ``vand_g_secret``, ``exchange`` (``[g_mix_t |
        vand_g_secret]``, ``[N', N + z]``: the exchange's one product) and
        ``decode_rows``."""
        dev = resolve_device(device)

        def build():
            host = {"vand_a": self.vand_a, "vand_b": self.vand_b,
                    "g_mix_t": self.g_mix.T.copy(),
                    "vand_g_secret": self.vand_g_secret,
                    "exchange": np.concatenate(
                        [self.g_mix.T, self.vand_g_secret], axis=1),
                    "decode_rows": self.decode_rows}
            return {k: torch.from_numpy(np.ascontiguousarray(host[k])).to(dev)
                    for k in _TABLES}

        return self.runner(("tables", str(dev)), build)

    def stages(self, device=None) -> ProtocolStages:
        """The staged programs for this plan on ``device`` (built once)."""
        dev = resolve_device(device)
        return self.runner(("stages", str(dev)),
                           lambda: _build_stages(self, dev))

    def batched(self, kind: str, device=None) -> Callable:
        """The engine's batched stage ``kind`` (``"vfront"``, ``"vtags"``
        or ``"vdecode"``, see :func:`_build_batched`) on ``device``,
        attached to this plan as the runner ``(kind, device)``."""
        if kind not in ("vfront", "vtags", "vdecode"):
            raise ValueError(f"unknown batched stage {kind!r}")
        dev = resolve_device(device)
        return self.runner((kind, str(dev)),
                           lambda: _build_batched(self, kind, dev))

    # ------------------------------------------------- survivor-solve cache
    def _solve_cached(self, key: Tuple, solve: Callable[[], object]):
        """LRU get-or-solve: recently-used survivor patterns stay hot; the
        cache evicts least-recently-used past SOLVE_CACHE_SIZE entries."""
        with self._runner_lock:
            val = self._solve_cache.get(key)
            if val is not None:
                self._solve_cache.move_to_end(key)
                self._solve_hits += 1
                return val
        val = solve()
        with self._runner_lock:
            hit = self._solve_cache.get(key)
            if hit is not None:  # benign solve race: keep the first
                self._solve_cache.move_to_end(key)
                self._solve_hits += 1
                return hit
            self._solve_misses += 1
            self._solve_cache[key] = val
            while len(self._solve_cache) > SOLVE_CACHE_SIZE:
                self._solve_cache.popitem(last=False)
        return val

    def survivor_rows(self, idx) -> np.ndarray:
        """Phase-3 decode rows ``[t², t²+z]`` for one survivor index tuple.

        ``idx``: the first ``t²+z`` alive worker indices, ascending.  The
        default prefix short-circuits to :attr:`decode_rows`; any other
        pattern hits the LRU, solved on miss.
        """
        t2z = self.recovery_threshold
        idx = tuple(int(i) for i in idx)
        if len(idx) != t2z:
            raise MaskShapeError(
                f"need exactly {t2z} survivor indices, got {len(idx)}",
                quorum=t2z, alive=len(idx), slots=idx)
        if idx == tuple(range(t2z)):
            return self.decode_rows

        def solve() -> np.ndarray:
            v = vandermonde(self.field, self.alphas[list(idx)],
                            np.arange(t2z, dtype=np.int64))
            return inv_mod(self.field, v)[: self.t * self.t]

        return self._solve_cached(("survivor", idx), solve)

    def survivor_tables(self, idx, device=None) -> Tuple:
        """Device-resident ``(indices, decode rows)`` for one survivor
        tuple, LRU-cached per device beside :meth:`survivor_rows`."""
        idx = tuple(int(i) for i in idx)
        dev = resolve_device(device)

        def build() -> Tuple:
            rows = self.survivor_rows(idx)
            return (torch.tensor(idx, dtype=torch.int64, device=dev),
                    torch.from_numpy(np.ascontiguousarray(rows)).to(dev))

        return self._solve_cached(("survivor_dev", idx, str(dev)), build)

    def quorum_weights(self, idx, pool_size: int) -> np.ndarray:
        """Phase-2 reconstruction weights (inverse of the generalized
        Vandermonde over ``P(H)``, eq. (9)) for an elastic-pool quorum of
        N indices into the ``pool_size`` pool; LRU-cached."""
        n = self.n_workers
        idx = tuple(int(i) for i in idx)
        if len(idx) != n:
            raise MaskShapeError(
                f"need exactly N={n} quorum indices, got {len(idx)}",
                quorum=n, alive=len(idx), slots=idx)

        def solve() -> np.ndarray:
            al = self.pool_alphas(pool_size)[list(idx)]
            v = vandermonde(self.field, al, self.powers_h)
            return inv_mod(self.field, v)

        return self._solve_cached(("quorum", pool_size, idx), solve)

    def solve_cache_info(self) -> Dict[str, int]:
        with self._runner_lock:
            return {"hits": self._solve_hits, "misses": self._solve_misses,
                    "size": len(self._solve_cache)}

    # --------------------------------------------------- spare α provisioning
    def pool_alphas(self, pool_size: int) -> np.ndarray:
        """Evaluation points for an elastic pool of ``pool_size ≥ N``.

        The first N are this plan's α's; spares extend the set with the
        smallest unused field points such that each new canonical
        prefix-failure quorum stays solvable over ``P(H)``, with the same
        deterministic re-seeding as the base search.  Memoized per size.
        """
        n = self.n_workers
        if pool_size < n:
            raise ValueError(f"pool_size {pool_size} < N={n}")
        if pool_size >= self.p:
            raise ValueError(
                f"pool_size {pool_size} needs distinct nonzero α's mod "
                f"{self.p}")
        with self._runner_lock:
            cached = self._pool_alphas.get(pool_size)
        if cached is not None:
            return cached
        pool = [int(a) for a in self.alphas]
        used = {a % self.p for a in pool}
        rng = np.random.default_rng(ALPHA_SEARCH_SEED)
        fresh = (a for a in range(1, min(self.p, ALPHA_POOL_LIMIT))
                 if a not in used)
        while len(pool) < pool_size:
            for _ in range(ALPHA_SEARCH_TRIES):
                cand = next(fresh, None)
                if cand is None:  # tiny fields: re-seeded random fallback
                    cand = int(rng.integers(1, self.p))
                    if cand in used:
                        continue
                quorum = pool[len(pool) - n + 1:] + [cand]
                if try_inverse(self.field,
                               vandermonde(self.field, quorum,
                                           self.powers_h)) is not None:
                    pool.append(cand)
                    used.add(cand % self.p)
                    break
            else:
                raise RuntimeError(
                    f"no invertible spare α found in {ALPHA_SEARCH_TRIES} "
                    f"tries extending pool to {len(pool) + 1}")
        arr = np.fromiter(pool, dtype=np.int64, count=len(pool))
        with self._runner_lock:
            arr = self._pool_alphas.setdefault(pool_size, arr)
        return arr


@functools.lru_cache(maxsize=None)
def _resolve_code(scheme: str, s: int, t: int, z: int,
                  lam: Optional[int]) -> GeneralizedPolyCode:
    if scheme == "age":
        if lam is None:
            return optimal_age_code(s, t, z)[0]
        return AGECode(s, t, z, lam)
    if scheme == "entangled":
        return AGECode(s, t, z, lam=0)
    if scheme == "polydot":
        return polydot_code(s, t, z)
    raise ValueError(f"unknown scheme {scheme!r}")


def build_plan(scheme: str, s: int, t: int, z: int, lam: Optional[int],
               field: Field, m: int) -> ProtocolPlan:
    """Construct a plan from scratch (no cache), element-equal to the
    reference planner's tables."""
    code = _resolve_code(scheme, s, t, z, lam)
    p = field.p
    n = code.n_workers
    powers_h = _sorted_powers(code.powers_h)
    t2 = t * t
    t2z = t2 + z
    pw_a = np.concatenate([_powers_a(code),
                           _sorted_powers(code.secret_powers_a)])
    pw_b = np.concatenate([_powers_b(code),
                           _sorted_powers(code.secret_powers_b)])
    max_pow = int(max(powers_h.max(), pw_a.max(), pw_b.max(), t2z - 1))

    # ---- α-set search: invertibility check and solve share one elimination
    holder = {}

    def _table_slice(f, cand, pw):
        holder["table"] = tbl = power_table(f, cand, max_pow)
        return tbl[:, pw]

    alphas, w = choose_alphas_with_inverse(
        field, n, powers_h, vand_fn=_table_slice)
    table = holder["table"]

    # ---- r_coeffs: rows of V⁻¹ at the important powers, ordered u = i + t·l
    pow_to_idx = {int(pw): k for k, pw in enumerate(powers_h)}
    rows = [
        w[pow_to_idx[(code.s - 1) * code.alpha + i * code.beta + code.theta * l]]
        for l in range(t) for i in range(t)
    ]
    r_coeffs = np.stack(rows).astype(np.int64)

    # ---- phase-1 share tables (coded powers then secret powers)
    vand_a = table[:n, pw_a]
    vand_b = table[:n, pw_b]

    # ---- phase-2 G-mix: c[n, n'] = Σ_u r_n^u · α_{n'}^u  (eq. (10), 1st sum)
    vg = table[:n, :t2]                                          # [N', t²]
    g_mix = matmul_mod(r_coeffs.T, vg.T, p)                      # [N, N']
    vand_g_secret = table[:n, t2:t2 + z]

    # ---- default phase-3 decode: first t²+z workers, coefficients 0..t²-1
    w_dec = try_inverse(field, table[:t2z, :t2z])
    if w_dec is None:  # cannot happen: plain Vandermonde, distinct α's
        raise np.linalg.LinAlgError("singular decode system")
    decode_rows = w_dec[:t2]

    return ProtocolPlan(
        scheme=scheme, s=s, t=t, z=z, m=m, p=p, code=code,
        alphas=alphas, powers_h=powers_h, r_coeffs=r_coeffs,
        vand_a=vand_a, vand_b=vand_b, g_mix=g_mix,
        vand_g_secret=vand_g_secret, decode_rows=decode_rows.astype(np.int64),
    )


def plan_from_arrays(*, scheme: str, s: int, t: int, z: int, alpha: int,
                     beta: int, theta: int, p: int, m: int,
                     alphas, powers_h, r_coeffs, vand_a, vand_b, g_mix,
                     vand_g_secret, decode_rows) -> ProtocolPlan:
    """A plan from table arrays built elsewhere (e.g. the JAX planner).

    ``alpha``/``beta``/``theta`` are the code's degree parameters; the
    arrays are the plan fields of the same names.  Shapes are checked
    against the code's worker count; the tables are taken as given.
    """
    code = GeneralizedPolyCode(s, t, z, alpha, beta, theta)
    n, t2, t2z = code.n_workers, t * t, t * t + z
    # analysis: allow(host-sync): host-side plan tables, copied once
    arrs = {k: np.array(v, dtype=np.int64, copy=True) for k, v in {
        "alphas": alphas, "powers_h": powers_h, "r_coeffs": r_coeffs,
        "vand_a": vand_a, "vand_b": vand_b, "g_mix": g_mix,
        "vand_g_secret": vand_g_secret, "decode_rows": decode_rows}.items()}
    want = {"alphas": (n,), "powers_h": (n,), "r_coeffs": (t2, n),
            "vand_a": (n, t * s + z), "vand_b": (n, t * s + z),
            "g_mix": (n, n), "vand_g_secret": (n, z),
            "decode_rows": (t2, t2z)}
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise ShapeContractError(
                f"plan table {k} has shape {arrs[k].shape}, expected {shape}",
                shapes=(arrs[k].shape, shape))
    if m % s or m % t:
        raise ValueError(f"need s|m and t|m: s={s} t={t} m={m}")
    return ProtocolPlan(scheme=scheme, s=s, t=t, z=z, m=m, p=p, code=code,
                        **arrs)


# ----------------------------------------------------------------- the cache
_CACHE: Dict[PlanKey, ProtocolPlan] = {}
_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0


def get_plan(scheme: str, s: int, t: int, z: int, lam: Optional[int],
             field: Field, m: int, *,
             placement: Optional[Tuple[int, ...]] = None) -> ProtocolPlan:
    """Memoized :func:`build_plan`, the entry point protocols use.

    ``placement`` (heterogeneous pools) qualifies the cache key without
    changing what is built: the plan returned IS the placement-free plan,
    registered under the qualified key as well."""
    global _HITS, _MISSES
    key: PlanKey = (scheme, s, t, z, lam, field.p, m)
    if placement is not None:
        key = key + (tuple(int(d) for d in placement),)
    with _LOCK:
        plan = _CACHE.get(key)
        if plan is not None:
            _HITS += 1
            return plan
    if placement is None:
        built = build_plan(scheme, s, t, z, lam, field, m)
    else:  # alias the shared placement-free plan (one build, one stage set)
        built = get_plan(scheme, s, t, z, lam, field, m)
    with _LOCK:
        plan = _CACHE.get(key)
        if plan is not None:  # lost a benign build race: keep the first
            _HITS += 1
            return plan
        _MISSES += 1
        _CACHE[key] = built
    return built


def cache_info() -> Dict[str, int]:
    with _LOCK:
        return {"hits": _HITS, "misses": _MISSES, "size": len(_CACHE)}


def cache_clear() -> None:
    global _HITS, _MISSES
    with _LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0

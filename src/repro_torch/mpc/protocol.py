"""Executable AGE-CMPC (paper §IV-B) on torch: the three phases, end to end.

Port of ``repro/mpc/protocol.py``.  The same machinery runs
Entangled-CMPC (λ=0) and PolyDot-CMPC, so the paper's baselines execute
too.  Phase 3 decodes from ANY ``t²+z`` surviving workers (``survivors``
masks).

:meth:`AGECMPCProtocol.run` has three modes, all exact and equal in ``Y``:

* ``"fused"`` (default) — the plan's staged programs
  (:class:`repro_torch.mpc.planner.ProtocolStages`); on a CUDA device every
  product is a hand-written kernel launch;
* ``"kernel"`` — phases 1–3 called on the kernel wrappers one by one,
  the structure of the reference's Pallas mode; the kernels fold at the
  field window, so unlike that mode it also serves Mersenne-31;
* ``"reference"`` — the eager phase-by-phase path ending in the
  per-call interpreted survivor solve (the exactness oracle).

Operands may be numpy arrays or tensors.  The device is ``device`` when
given, else the operand tensor's device, else the card; with no card and
no device the run raises.  ``key`` is an int seed or a
``torch.Generator`` on that device; secrets and masks are drawn from it.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..core.age import GeneralizedPolyCode
from ..kernels import modmatmul as _kmm
from ..kernels import polyeval as _kpe
from ..kernels.barrett import mod_p
from .api import MPCSpec
from .errors import AdversaryBudgetError, QuorumError
from .field import (
    DEFAULT_FIELD,
    Field,
    acc_window,
    as_int64,
    generator,
    resolve_device,
)
from .lagrange import inv_mod, vandermonde
from .planner import PlanKey, ProtocolPlan

MODES = ("fused", "kernel", "reference")


def _device_of(x, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return resolve_device(x.device)
    return resolve_device(None)


def _eager_apply(v: torch.Tensor, x: torch.Tensor, p: int) -> torch.Tensor:
    """``(Σ_k v[n, k]·x[k, ...]) mod p`` summed raw in one int64 window,
    as elementwise passes (CUDA has no int64 GEMM or einsum)."""
    acc = torch.zeros((v.shape[0],) + tuple(x.shape[1:]), dtype=torch.int64,
                      device=x.device)
    for k in range(v.shape[1]):
        acc += v[:, k].reshape((-1,) + (1,) * (x.ndim - 1)) * x[k]
    return torch.remainder(acc, p)


@dataclasses.dataclass(frozen=True)
class AGECMPCProtocol:
    """Plan + executable phases for one ``Y = AᵀB`` under CMPC.

    Parameters
    ----------
    s, t : matrix partitions (s | m and t | m required)
    z    : collusion bound
    m    : matrix side
    lam  : AGE gap; ``None`` solves ``min_λ`` (eq. (13))
    scheme : "age" | "entangled" | "polydot"

    ``pool`` and ``placement`` (the device roster and the roster device
    serving each slot) only group and route attrition: the phase math and
    the plan tables do not depend on them.  ``adversaries`` > 0 routes
    :meth:`run` through the MAC-verified decode.
    """

    s: int
    t: int
    z: int
    m: int
    lam: Optional[int] = None
    scheme: str = "age"
    field: Field = DEFAULT_FIELD
    pool: Optional[object] = None
    placement: Optional[tuple] = None
    adversaries: int = 0

    def __post_init__(self):
        if self.m % self.s or self.m % self.t:
            raise ValueError(f"need s|m and t|m: s={self.s} t={self.t} m={self.m}")

    # ------------------------------------------------------------------ spec
    @classmethod
    def from_spec(cls, spec: MPCSpec, m: Optional[int] = None
                  ) -> "AGECMPCProtocol":
        """A protocol instance for one :class:`MPCSpec` at block side
        ``m`` (defaults to ``spec.m``)."""
        return cls(s=spec.s, t=spec.t, z=spec.z, m=spec._block(m),
                   lam=spec.lam, scheme=spec.scheme, field=spec.field,
                   pool=spec.pool, placement=spec.effective_placement,
                   adversaries=spec.adversaries)

    @cached_property
    def spec(self) -> MPCSpec:
        return MPCSpec(s=self.s, t=self.t, z=self.z, lam=self.lam,
                       scheme=self.scheme, field=self.field, m=self.m,
                       pool=self.pool, placement=self.placement,
                       adversaries=self.adversaries)

    @property
    def plan_key(self) -> PlanKey:
        return self.spec.plan_key()

    @property
    def group_key(self):
        return self.spec.group_key()

    # ------------------------------------------------------------------ plan
    @cached_property
    def plan(self) -> ProtocolPlan:
        """The cached data-independent tables (shared across instances)."""
        return self.spec.plan()

    @property
    def code(self) -> GeneralizedPolyCode:
        return self.plan.code

    @property
    def n_workers(self) -> int:
        return self.plan.n_workers

    @property
    def recovery_threshold(self) -> int:
        return self.plan.recovery_threshold

    @property
    def powers_h(self) -> np.ndarray:
        return self.plan.powers_h

    @property
    def alphas(self) -> np.ndarray:
        return self.plan.alphas

    @property
    def r_coeffs(self) -> np.ndarray:
        return self.plan.r_coeffs

    @property
    def vand_a(self) -> np.ndarray:
        return self.plan.vand_a

    @property
    def vand_b(self) -> np.ndarray:
        return self.plan.vand_b

    @property
    def g_mix(self) -> np.ndarray:
        return self.plan.g_mix

    @property
    def vand_g_secret(self) -> np.ndarray:
        return self.plan.vand_g_secret

    # -------------------------------------------------------------- phase 1
    def _split_a(self, a: torch.Tensor) -> torch.Tensor:
        """Aᵀ -> [t·s, m/t, m/s] blocks, i-major (matches planner powers)."""
        t, s, m = self.t, self.s, self.m
        blocks = a.T.reshape(t, m // t, s, m // s).permute(0, 2, 1, 3)
        return blocks.reshape(t * s, m // t, m // s)

    def _split_b(self, b: torch.Tensor) -> torch.Tensor:
        """B -> [s·t, m/s, m/t] blocks, k-major (matches planner powers)."""
        t, s, m = self.t, self.s, self.m
        blocks = b.reshape(s, m // s, t, m // t).permute(0, 2, 1, 3)
        return blocks.reshape(s * t, m // s, m // t)

    def phase1_shares(self, a: torch.Tensor, b: torch.Tensor,
                      gen: torch.Generator):
        """Sources build F_A(α_n), F_B(α_n) for every worker n (eager, one
        fold after all ``ts+z`` terms).  Returns ``(f_a, f_b)``."""
        dev = a.device
        mt, ms = self.m // self.t, self.m // self.s
        sec_a = self.field.random(gen, (self.z, mt, ms))
        sec_b = self.field.random(gen, (self.z, ms, mt))
        terms_a = torch.cat([self._split_a(a), sec_a])       # [ts+z, mt, ms]
        terms_b = torch.cat([self._split_b(b), sec_b])       # [ts+z, ms, mt]
        p = self.field.p
        f_a = _eager_apply(as_int64(self.vand_a, dev), terms_a, p)
        f_b = _eager_apply(as_int64(self.vand_b, dev), terms_b, p)
        return f_a, f_b

    # -------------------------------------------------------------- phase 2
    def phase2_compute(self, f_a: torch.Tensor, f_b: torch.Tensor, *,
                       use_kernel: bool = False) -> torch.Tensor:
        """Each worker: H(α_n) = F_A(α_n)·F_B(α_n) mod p  (the hot loop).

        ``use_kernel=True`` launches the batched kernel (all N workers in
        one launch; its plain version on a CPU tensor)."""
        if use_kernel:
            return _kmm.modmatmul_batched(f_a.contiguous(), f_b.contiguous(),
                                          p=self.field.p)
        return self.field.matmul(f_a, f_b)

    def phase2_exchange(self, h: torch.Tensor, gen: torch.Generator):
        """Workers build G_n, exchange points, sum: returns I(α_{n'}).

        Simulated in one process: the exchange collapses to two table
        applications, each folded once."""
        dev = h.device
        n, mt, p = self.n_workers, self.m // self.t, self.field.p
        r_mask = self.field.random(gen, (n, self.z, mt, mt))
        i_pts = _eager_apply(as_int64(self.g_mix.T, dev), h, p)
        mask_sum = torch.remainder(r_mask.sum(dim=0), p)     # [z, mt, mt]
        vg = as_int64(self.vand_g_secret, dev)
        return torch.remainder(i_pts + _eager_apply(vg, mask_sum, p), p)

    # -------------------------------------------------------------- phase 3
    def survivor_prefix(self, survivors: Optional[np.ndarray]) -> np.ndarray:
        """First ``t²+z`` alive worker indices for a survivor mask (raises
        through :meth:`MPCSpec.validate_survivors`)."""
        return self.spec.validate_survivors(survivors)

    def decode(self, i_points, survivors: Optional[np.ndarray] = None, *,
               device=None):
        """Master reconstructs Y from any t²+z surviving I(α_n) points,
        through the plan's decode stage and cached survivor rows."""
        dev = _device_of(i_points, device)
        idx = self.survivor_prefix(survivors)
        idx_t, rows_t = self.plan.survivor_tables(tuple(idx), dev)
        return self.plan.stages(dev).decode(
            as_int64(i_points, dev), idx_t, rows_t)

    # ------------------------------------------------------------------ run
    def run(self, a, b, key, *, survivors: Optional[np.ndarray] = None,
            mode: str = "fused", device=None):
        """All three phases; returns Y = AᵀB mod p as an int64 tensor.

        ``mode``: ``"fused"`` (the staged programs; a survivor mask swaps
        the decode rows in from the plan's LRU), ``"kernel"`` (the kernel
        wrappers called phase by phase) or ``"reference"`` (the eager
        oracle, which folds whole term/worker sums in one int64 window and
        so refuses fields whose window is too small, like Mersenne-31).
        """
        if mode not in MODES:
            raise ValueError(
                f"unknown mode {mode!r}: expected fused|kernel|reference")
        dev = _device_of(a, device)
        a = as_int64(a, dev)
        b = as_int64(b, dev)
        gen = generator(key, dev)
        if mode == "reference":
            return self.run_reference(a, b, gen, survivors=survivors)
        if mode == "kernel":
            return self._run_kernel(a, b, gen, survivors=survivors)
        if self.adversaries:
            # a Byzantine budget makes verification non-optional (equal to
            # the honest run when nobody lies)
            return self.run_verified(a, b, key, survivors=survivors,
                                     device=dev)[0]
        stages = self.plan.stages(dev)
        if survivors is None:
            return stages.fused(a, b, gen)
        idx = self.survivor_prefix(survivors)
        idx_t, rows_t = self.plan.survivor_tables(tuple(idx), dev)
        return stages.decode(stages.front(a, b, gen), idx_t, rows_t)

    # -------------------------------------------------- Byzantine tolerance
    def run_verified(self, a, b, key, *,
                     survivors: Optional[np.ndarray] = None,
                     injector=None, round_id: int = 0, device=None):
        """All three phases with MAC-verified decode.

        Returns ``(y, verdict)``.  ``y`` equals the honest ``run`` whenever
        at most ``spec.adversaries`` shares were corrupted: liars are found
        by their failed tags, excluded, and the decode interpolates from
        the first ``t²+z`` honest survivors.  ``injector`` (a
        :class:`~repro_torch.mpc.byzantine.FaultInjector`) corrupts shares
        and tags between tagging and the check.  Raises
        :class:`~repro_torch.mpc.errors.AdversaryBudgetError` when more
        liars are found than the budget tolerates.  The I-points, their
        tags and every correction stay on the device.
        """
        from . import byzantine as byz

        dev = _device_of(a, device)
        gen = generator(key, dev)
        i_pts = self.plan.stages(dev).front(as_int64(a, dev),
                                            as_int64(b, dev), gen)
        tags = byz.share_tags(self.plan, i_pts, key)
        if injector is not None:
            i_pts, tags = injector.corrupt(self.plan, i_pts, tags, round_id)
        return self.verified_decode(i_pts, tags, key, survivors=survivors)

    def verified_decode(self, i_points, tags, key, *,
                        survivors: Optional[np.ndarray] = None, device=None):
        """Check the shares' MACs, exclude liars, decode from the honest
        survivors.

        Validates the mask at the verified quorum ``t²+z+2a``, recomputes
        every slot's tag, and decodes through the plan's survivor tables
        like a dropout mask.  The honesty mask comes to the host (it
        decides which rows decode).  Returns ``(y, Verdict)``.
        """
        from . import byzantine as byz

        spec = self.spec
        budget = spec.adversaries
        n = self.n_workers
        dev = _device_of(i_points, device)
        i_points = as_int64(i_points, dev)
        spec.validate_survivors(survivors)       # shape + verified quorum
        alive = (np.ones(n, bool) if survivors is None
                 # analysis: allow(host-sync): survivor masks are host data
                 else np.asarray(survivors, bool))
        honest = byz.check_shares(self.plan, i_points, tags, key)
        liars = np.nonzero(alive & ~honest)[0]
        if len(liars) > budget:
            raise AdversaryBudgetError(
                f"adversary budget exhausted: {len(liars)} corrupted "
                f"shares detected > budget a={budget}",
                spec=spec, quorum=budget, alive=int(alive.sum()),
                slots=liars)
        idx = spec.validate_survivors(alive & honest, corrected=True)
        idx_t, rows_t = self.plan.survivor_tables(tuple(idx), dev)
        y = self.plan.stages(dev).decode(i_points, idx_t, rows_t)
        return y, byz.Verdict(liars=tuple(int(w) for w in liars),
                              corrected=int(len(liars)),
                              quorum=tuple(int(i) for i in idx))

    def decode_corrected(self, i_points, *,
                         survivors: Optional[np.ndarray] = None,
                         max_errors: Optional[int] = None, seed: int = 0,
                         device=None):
        """Tag-free error-correcting decode (Berlekamp–Welch).

        Compresses each survivor's share to one scalar with a seeded random
        vector (the reference's NumPy draw, so both packages compress
        alike), locates the corrupted evaluations with
        :func:`~repro_torch.mpc.byzantine.locate_errors` over the plan's
        α-set, and decodes from the first ``t²+z`` clean survivors.  The
        compression is one skinny ``modmatmul`` on the device; only the
        ``[alive]`` scalars come to the host.  Returns ``(y, liar_slots)``.
        """
        from . import byzantine as byz

        budget = (self.spec.adversaries if max_errors is None
                  else int(max_errors))
        n = self.n_workers
        t2z = self.recovery_threshold
        p = self.field.p
        spec = self.spec if max_errors is None else dataclasses.replace(
            self.spec, adversaries=budget)
        spec.validate_survivors(survivors)       # shape + t²+z+2a quorum
        alive = (np.ones(n, bool) if survivors is None
                 # analysis: allow(host-sync): survivor masks are host data
                 else np.asarray(survivors, bool))
        aidx = np.nonzero(alive)[0]
        dev = _device_of(i_points, device)
        pts = torch.remainder(as_int64(i_points, dev), p)
        flat = pts.index_select(0, torch.from_numpy(aidx).to(dev)).reshape(
            len(aidx), -1)
        rng = np.random.default_rng(seed)
        rvec = rng.integers(0, p, size=flat.shape[1], dtype=np.int64)
        comp = _kmm.modmatmul(flat.contiguous(),
                              torch.from_numpy(rvec).to(dev).reshape(-1, 1),
                              p=p)[:, 0]
        # analysis: allow(host-sync): one scalar per survivor for the solve
        comp = comp.cpu().numpy()
        bad = byz.locate_errors(self.field, self.plan.alphas[aidx], comp,
                                t2z, budget)
        liars = aidx[bad]
        clean = alive.copy()
        clean[liars] = False
        idx = spec.validate_survivors(clean, corrected=True)
        idx_t, rows_t = self.plan.survivor_tables(tuple(int(i) for i in idx),
                                                  dev)
        y = self.plan.stages(dev).decode(pts, idx_t, rows_t)
        return y, tuple(int(w) for w in liars)

    def run_reference(self, a: torch.Tensor, b: torch.Tensor,
                      gen: torch.Generator, *,
                      survivors: Optional[np.ndarray] = None):
        """The eager phase-by-phase pipeline (oracle), ending in the
        per-call interpreted survivor solve."""
        self._require_window("run_reference (mode='reference')")
        f_a, f_b = self.phase1_shares(a, b, gen)
        h = self.phase2_compute(f_a, f_b)
        i_pts = self.phase2_exchange(h, gen)
        return self._decode_seed(i_pts, survivors)

    def _decode_seed(self, i_points: torch.Tensor,
                     survivors: Optional[np.ndarray] = None):
        """Decode with the interpreted (object-dtype) survivor solve."""
        from .lagrange import inv_mod_ref, vandermonde_ref

        t2z = self.recovery_threshold
        alive = (np.ones(self.n_workers, bool) if survivors is None
                 # analysis: allow(host-sync): survivor masks are host data
                 else np.asarray(survivors, bool))
        idx = np.nonzero(alive)[0]
        if len(idx) < t2z:
            raise QuorumError(
                f"only {len(idx)} workers alive < threshold {t2z}",
                quorum=t2z, alive=len(idx))
        idx = idx[:t2z]
        v = vandermonde_ref(self.field, self.alphas[idx], list(range(t2z)))
        w = inv_mod_ref(self.field, v)[: self.t * self.t]
        dev = i_points.device
        i_sel = i_points.index_select(0, torch.from_numpy(idx).to(dev))
        y_blocks = _eager_apply(as_int64(w, dev), i_sel, self.field.p)
        t, mt = self.t, self.m // self.t
        grid = y_blocks.reshape(t, t, mt, mt)       # [l, i, r, c]
        return grid.permute(1, 2, 0, 3).reshape(self.m, self.m)

    def _require_window(self, what: str) -> None:
        """Raise if the field's int64 window can't cover this path's
        single-fold accumulations (ts+z phase-1 terms, N exchange terms)."""
        need = max(self.s * self.t + self.z, self.n_workers)
        win = acc_window(self.field.p)
        if win < need:
            raise ValueError(
                f"{what} folds {need} products in one int64 window but "
                f"acc_window({self.field.p})={win}; use the fused or kernel "
                "mode for small-window fields")

    def _run_kernel(self, a: torch.Tensor, b: torch.Tensor,
                    gen: torch.Generator, *,
                    survivors: Optional[np.ndarray] = None):
        """Phases 1-3 on the kernel wrappers, one call per product."""
        dev = a.device
        dec_idx = self.survivor_prefix(survivors)
        idx_t, rows_t = self.plan.survivor_tables(tuple(dec_idx), dev)
        tab = self.plan.tables(dev)
        p = self.field.p
        t, z, m = self.t, self.z, self.m
        mt, ms = m // t, m // self.s
        n = self.n_workers
        sec_a = self.field.random(gen, (z, mt, ms))
        sec_b = self.field.random(gen, (z, ms, mt))
        terms_a = torch.cat([self._split_a(a), sec_a]).reshape(-1, mt * ms)
        terms_b = torch.cat([self._split_b(b), sec_b]).reshape(-1, ms * mt)
        f_a = _kpe.polyeval(tab["vand_a"], terms_a, p=p).reshape(n, mt, ms)
        f_b = _kpe.polyeval(tab["vand_b"], terms_b, p=p).reshape(n, ms, mt)
        h = self.phase2_compute(f_a, f_b, use_kernel=True)
        r_mask = self.field.random(gen, (n, z, mt, mt))
        mask_sum = mod_p(r_mask.sum(dim=0), p)
        i_pts = _kpe.polyeval(tab["exchange"], (h.reshape(n, mt * mt),
                                                mask_sum.reshape(z, mt * mt)),
                              p=p)
        y_blocks = _kpe.polyeval(rows_t, i_pts, p=p, rows=idx_t)
        grid = y_blocks.reshape(t, t, mt, mt)
        return grid.permute(1, 2, 0, 3).reshape(m, m)

    # ------------------------------------------------------------- privacy
    def check_privacy_structure(self, n_subsets: int = 32, seed: int = 0) -> None:
        """The information-theoretic masking condition: for ANY ≤z colluding
        workers, the z×z secret-power Vandermonde submatrix is invertible.
        Exhaustive when the subset count is small, randomized otherwise."""
        from itertools import combinations

        sec_a = sorted(self.code.secret_powers_a)
        sec_b = sorted(self.code.secret_powers_b)
        combos = list(combinations(range(self.n_workers), self.z))
        if len(combos) > n_subsets:
            rng = np.random.default_rng(seed)
            sel = rng.choice(len(combos), n_subsets, replace=False)
            combos = [combos[i] for i in sel]
        for subset in combos:
            al = self.alphas[list(subset)]
            for pw in (sec_a, sec_b):
                v = vandermonde(self.field, al, pw)
                inv_mod(self.field, v)  # raises LinAlgError if singular


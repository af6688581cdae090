"""Byzantine-tolerant decode on torch: share MACs + error-locating
interpolation (port of ``repro/mpc/byzantine.py``).

* **Per-share field MACs.**  For a request keyed by ``key``, derive
  ``(γ, o_0..o_{N-1}, r)`` from a ``torch.Generator`` seeded with
  ``fold_in(key, MAC_FOLD)``: a nonzero MAC scalar, per-slot offsets and a
  compression vector.  Every worker's share is tagged as::

      tag_n = γ · ⟨vec(I(α_n)), r⟩ + o_n   (mod p)

  The compression is the plan's ``tags`` stage: one skinny mod-p product
  on the card (``kernels.modmatmul``'s ``skinny`` instance).  A tamperer
  who does not know ``γ`` forges a valid tag with probability ``1/p``, so
  the check localizes liars by slot before decode.  The draws differ from
  the reference's ``jax.random`` ones; tags are equal given the same
  ``(γ, o, r)``.
* **Error-locating interpolation** (:func:`locate_errors`): Berlekamp–Welch
  over ``F_p``, host-side NumPy, kept as copies of the reference's.
* **A seeded fault-injection harness** (:class:`FaultInjector`): the same
  NumPy seed formulas as the reference, so one schedule corrupts the same
  slots with the same deltas, and the same ``SCHEDULE_VERSION = 1`` JSON
  documents.  Corruption works on the device: only a corrupted slot's
  delta is uploaded, and the honest shares kept for ``"stale"`` replays
  stay on the device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import AdversaryBudgetError, QuorumError
from .field import Field, as_int64, fold_in, generator
from .lagrange import matmul_mod, vandermonde

#: fold constant deriving the MAC key stream from a request key; distinct
#: from the small per-block counters the session folds in
MAC_FOLD = 0x4D41C5


# ==================================================================== MACs
def mac_params(plan, key, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The request's MAC parameters ``(γ, offsets [N], r [mt·mt])`` on
    ``device`` (default: a generator key's device, else the CPU).

    Drawn, in that order, from a generator seeded with ``fold_in(key,
    MAC_FOLD)``, so sources and master agree without communication; γ is
    nonzero."""
    if device is None:
        device = key.device if isinstance(key, torch.Generator) else "cpu"
    gen = generator(fold_in(key, MAC_FOLD), torch.device(device))
    p, n, mt = plan.p, plan.n_workers, plan.m // plan.t
    dev = gen.device
    gamma = torch.randint(1, p, (), generator=gen, device=dev,
                          dtype=torch.int64)
    offsets = torch.randint(0, p, (n,), generator=gen, device=dev,
                            dtype=torch.int64)
    rvec = torch.randint(0, p, (mt * mt,), generator=gen, device=dev,
                         dtype=torch.int64)
    return gamma, offsets, rvec


def share_tags(plan, i_points, key) -> torch.Tensor:
    """Honest MAC tags ``[N]`` for one request's shares, through the plan's
    ``tags`` stage on the shares' device."""
    i_points = as_int64(i_points)
    dev = i_points.device
    gamma, offsets, rvec = mac_params(plan, key, dev)
    return plan.stages(dev).tags(i_points, gamma, offsets, rvec)


def check_shares(plan, i_points, tags, key) -> np.ndarray:
    """Recompute the tags of the (possibly corrupted) shares and compare:
    a bool ``[N]`` honesty mask on the host (``False``: a liar, up to the
    MAC's ``1/p`` forgery chance)."""
    fresh = share_tags(plan, i_points, key)
    same = torch.eq(fresh, as_int64(tags, fresh.device))
    # analysis: allow(host-sync): the honesty mask drives control flow
    return same.cpu().numpy()


# ==================================================== Berlekamp–Welch decode
def _solve_any(p: int, a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """One particular solution of ``a x = b`` over ``F_p`` or ``None``.

    Rank-revealing Gauss–Jordan on the augmented system, free variables
    pinned to 0 (residues < p < 2³¹, so every product fits int64)."""
    # analysis: allow(host-sync): host-side NumPy decode
    a = np.atleast_2d(np.asarray(a, np.int64)) % p
    # analysis: allow(host-sync): host-side NumPy decode
    b = np.asarray(b, np.int64) % p
    rows, cols = a.shape
    aug = np.concatenate([a, b.reshape(rows, 1)], axis=1)
    piv_cols: List[int] = []
    r = 0
    for c in range(cols):
        if r == rows:
            break
        nz = np.nonzero(aug[r:, c])[0]
        if nz.size == 0:
            continue
        piv = r + int(nz[0])
        if piv != r:
            aug[[r, piv]] = aug[[piv, r]]
        inv = pow(int(aug[r, c]), p - 2, p)
        aug[r] = aug[r] * inv % p
        f = aug[:, c].copy()
        f[r] = 0
        aug = (aug - f[:, None] * aug[r][None, :]) % p
        piv_cols.append(c)
        r += 1
    # a zeroed-out row demanding a nonzero rhs: inconsistent system
    if np.any((aug[r:, :cols] == 0).all(axis=1) & (aug[r:, cols] != 0)):
        return None
    x = np.zeros(cols, np.int64)
    for i, c in enumerate(piv_cols):
        x[c] = aug[i, cols]
    return x


def _poly_eval(field: Field, coeffs: np.ndarray,
               alphas: np.ndarray) -> np.ndarray:
    """Evaluate ``Σ coeffs[j]·x^j`` at every α (Vandermonde row dot)."""
    v = vandermonde(field, alphas, np.arange(len(coeffs), dtype=np.int64))
    # analysis: allow(host-sync): host-side NumPy decode
    return matmul_mod(v, np.asarray(coeffs, np.int64).reshape(-1, 1),
                      field.p)[:, 0]


def _poly_divmod(num: np.ndarray, den: np.ndarray,
                 p: int) -> Optional[np.ndarray]:
    """``num / den`` over ``F_p[x]`` (coeffs low→high, ``den`` monic);
    ``None`` when the division leaves a remainder (no valid codeword)."""
    num = list(int(v) % p for v in num)
    den = [int(v) % p for v in den]
    dd = len(den) - 1
    out = [0] * max(len(num) - dd, 0)
    for i in range(len(num) - 1, dd - 1, -1):
        q = num[i] % p
        out[i - dd] = q
        if q:
            for j, dv in enumerate(den):
                num[i - dd + j] = (num[i - dd + j] - q * dv) % p
    if any(v % p for v in num[:dd] or [0]):
        return None
    return np.fromiter(out, dtype=np.int64, count=len(out))


def locate_errors(field: Field, alphas: Sequence[int], values: Sequence[int],
                  degree_bound: int, max_errors: int) -> np.ndarray:
    """Positions (into ``alphas``) whose ``values`` are corrupted.

    Berlekamp–Welch over ``F_p``: ``values[i]`` claims to be
    ``I(alphas[i])`` for a polynomial ``I`` of ``degree_bound``
    coefficients, with at most ``max_errors`` claims wrong; needs
    ``len(alphas) >= degree_bound + 2·max_errors`` points.  Walks the trial
    error count down, extracts ``I = Q/E`` and checks it explains every
    non-root position.  Returns the sorted positions; raises
    :class:`QuorumError` on too few points and
    :class:`AdversaryBudgetError` when no decoding fits the budget.
    """
    p = field.p
    # analysis: allow(host-sync): host-side NumPy decode
    al = np.atleast_1d(np.asarray(alphas, np.int64)) % p
    # analysis: allow(host-sync): host-side NumPy decode
    y = np.atleast_1d(np.asarray(values, np.int64)) % p
    q = len(al)
    d = int(degree_bound)
    if q < d + 2 * max_errors:
        raise QuorumError(
            f"error-locating decode needs {d + 2 * max_errors} points for "
            f"budget a={max_errors}, got only {q}",
            quorum=d + 2 * max_errors, alive=q)
    for a_try in range(min(int(max_errors), (q - d) // 2), -1, -1):
        nq = d + a_try                       # Q = I·E has nq coefficients
        vq = vandermonde(field, al, np.arange(nq, dtype=np.int64))
        # analysis: allow(shape-loop): host-side NumPy decode, never traced
        ve = vandermonde(field, al, np.arange(a_try, dtype=np.int64))
        # analysis: allow(host-sync): host-side NumPy decode
        lead = vandermonde(field, al, np.array([a_try], np.int64))[:, 0]
        mat = np.concatenate([vq, (-(y[:, None] * ve)) % p], axis=1)
        rhs = y * lead % p
        sol = _solve_any(p, mat, rhs)
        if sol is None:
            continue
        e_coeffs = np.concatenate([sol[nq:], [1]])       # monic E, low→high
        i_coeffs = _poly_divmod(sol[:nq], e_coeffs, p)
        if i_coeffs is None:
            continue
        pred = _poly_eval(field, np.pad(i_coeffs, (0, d - len(i_coeffs))),
                          al)
        bad = np.nonzero(pred != y)[0]
        if len(bad) > a_try:
            continue                          # overshot: fewer real errors
        return bad.astype(np.int64)
    raise AdversaryBudgetError(
        f"no consistent decoding within adversary budget a={max_errors} "
        f"over {q} points (degree bound {d})",
        quorum=d + 2 * max_errors, alive=q)


# =============================================================== verdicts
@dataclasses.dataclass(frozen=True)
class Verdict:
    """What a verified decode concluded about one request's shares."""

    liars: Tuple[int, ...]      # slots whose shares failed verification
    corrected: int              # corrupted shares detected and excluded
    quorum: Tuple[int, ...]     # honest decode prefix actually used


# ======================================================== fault injection
@dataclasses.dataclass
class FaultInjector:
    """Deterministic, seeded share-corruption schedules (the test harness).

    Wraps a backend's shares *after* honest tagging and *before*
    verification.  ``schedule``: ``{round_id: [(slot, mode), ...]}``,
    exact per round; ``rate`` + ``slots``: each candidate slot corrupted
    with probability ``rate`` under ``mode``.  Modes: ``"tamper"`` (add a
    uniform nonzero delta to every entry of the slot's share), ``"flip"``
    (flip bit 0 of every entry), ``"stale"`` (replay the slot's share from
    the previous round this injector saw; zeros on the first), ``"tag"``
    (corrupt only the MAC tag).  Every applied corruption is appended to
    :attr:`log` as ``(round_id, slot, mode)``.

    The seeds and draws are the reference's NumPy formulas, so a schedule
    gives the same log and deltas in both packages.  :meth:`corrupt` works
    on the shares' device and returns new tensors (the inputs are never
    written); only a tampered slot's delta crosses to the device.
    """

    seed: int = 0
    schedule: Optional[Dict[int, Sequence[Tuple[int, str]]]] = None
    rate: float = 0.0
    slots: Optional[Sequence[int]] = None
    mode: str = "tamper"

    MODES = ("tamper", "flip", "stale", "tag")

    #: fault-schedule file version (bump on any shape change)
    SCHEDULE_VERSION = 1

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}: expected one of {self.MODES}")
        if not 0.0 <= float(self.rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate!r}")
        if self.schedule is not None:
            for rnd, ents in self.schedule.items():
                for slot, mode in ents:
                    if mode not in self.MODES:
                        raise ValueError(
                            f"unknown mode {mode!r} in schedule round "
                            f"{rnd}: expected one of {self.MODES}")
        self.log: List[Tuple[int, int, str]] = []
        # the last round's honest shares, on their device; kept only when
        # some round can replay them
        self._stale: Optional[torch.Tensor] = None
        self._keeps_stale = (self.rate > 0.0 and self.mode == "stale") or any(
            mode == "stale" for ents in (self.schedule or {}).values()
            for _, mode in ents)

    # ------------------------------------------------------------ planning
    def plan_round(self, round_id: int, n: int) -> List[Tuple[int, str]]:
        """The (slot, mode) corruptions to apply in one round."""
        out: List[Tuple[int, str]] = []
        if self.schedule is not None:
            out.extend((int(s), m) for s, m in
                       self.schedule.get(int(round_id), ())
                       if 0 <= int(s) < n)
        if self.rate > 0.0:
            rng = np.random.default_rng(
                (int(self.seed) * 0x9E3779B1 + int(round_id)) % 2**63)
            cand = (range(n) if self.slots is None
                    else [int(s) for s in self.slots if 0 <= int(s) < n])
            out.extend((s, self.mode) for s in cand
                       if rng.random() < self.rate)
        return out

    # ----------------------------------------------------------- corruption
    def corrupt(self, plan, i_points, tags, round_id: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply this round's corruptions to one request's shares ``[N,
        mt, mt]`` and tags ``[N]``; returns ``(shares, tags)`` on the
        shares' device (the inputs themselves when nothing applies)."""
        p = plan.p
        honest = as_int64(i_points)
        tgs = as_int64(tags, honest.device)
        pts = honest
        plan_ents = self.plan_round(round_id, honest.shape[0])
        if plan_ents:
            pts, tgs = honest.clone(), tgs.clone()
        for slot, mode in plan_ents:
            rng = np.random.default_rng(
                (int(self.seed) * 0x9E3779B1 + int(round_id) * 0x85EBCA77
                 + slot) % 2**63)
            if mode == "tamper":
                delta = rng.integers(1, p, size=tuple(pts[slot].shape))
                pts[slot] = torch.remainder(
                    pts[slot] + torch.from_numpy(delta).to(pts.device), p)
            elif mode == "flip":
                # residues < p < 2³¹: flipping bit 0 stays below 2³¹ and
                # always changes the value mod p
                pts[slot] = torch.remainder(pts[slot] ^ 1, p)
            elif mode == "stale":
                prev = self._stale
                pts[slot] = (0 if prev is None or slot >= prev.shape[0]
                             else prev[slot])
            elif mode == "tag":
                tgs[slot] = (tgs[slot] + int(rng.integers(1, p))) % p
            self.log.append((int(round_id), int(slot), mode))
        # the HONEST shares, for the next round's stale replays
        if self._keeps_stale:
            self._stale = honest.clone()
        return pts, tgs

    def applied(self, round_id: Optional[int] = None
                ) -> List[Tuple[int, int, str]]:
        """The corruption log, optionally filtered to one round."""
        if round_id is None:
            return list(self.log)
        return [e for e in self.log if e[0] == int(round_id)]

    # ------------------------------------------------------------- persist
    def to_json(self) -> Dict:
        """This injector's configuration as the reference's JSON document
        (``[round, slot, mode]`` triples); the log is state, not
        configuration, and does not round-trip."""
        sched: List[List] = []
        if self.schedule is not None:
            for rnd in sorted(int(r) for r in self.schedule):
                for slot, mode in self.schedule[rnd]:
                    sched.append([int(rnd), int(slot), str(mode)])
        return {"version": self.SCHEDULE_VERSION, "seed": int(self.seed),
                "schedule": sched, "rate": float(self.rate),
                "slots": (None if self.slots is None
                          else [int(s) for s in self.slots]),
                "mode": str(self.mode)}

    @classmethod
    def from_json(cls, doc: Dict) -> "FaultInjector":
        """Rebuild an injector from :meth:`to_json` output (either
        package's); an empty schedule normalizes to ``None``."""
        if doc.get("version") != cls.SCHEDULE_VERSION:
            raise ValueError(
                f"unsupported fault-schedule version {doc.get('version')!r}"
                f" (expected {cls.SCHEDULE_VERSION})")
        sched: Optional[Dict[int, List[Tuple[int, str]]]] = None
        if doc.get("schedule"):
            sched = {}
            for rnd, slot, mode in doc["schedule"]:
                sched.setdefault(int(rnd), []).append((int(slot),
                                                      str(mode)))
        slots = doc.get("slots")
        return cls(seed=int(doc.get("seed", 0)), schedule=sched,
                   rate=float(doc.get("rate", 0.0)),
                   slots=(None if slots is None
                          else tuple(int(s) for s in slots)),
                   mode=str(doc.get("mode", "tamper")))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "FaultInjector":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_fleet_events(self, *, round_us: float = 1.0) -> List:
        """The scripted schedule as :class:`repro_torch.sim.trace.FleetEvent`
        corruption events (``at_us = round · round_us``): the fleet-sim
        replay view of the shared schedule file.  Rate-driven corruption
        has no scripted times and is not projected."""
        from ..sim.trace import FleetEvent

        events = []
        if self.schedule is not None:
            for rnd in sorted(int(r) for r in self.schedule):
                for slot, _mode in self.schedule[rnd]:
                    events.append(FleetEvent(at_us=float(rnd) * round_us,
                                             device=int(slot),
                                             kind="corrupt"))
        return events

"""Protocol-invariant prover: degree/quorum inequalities, every path.

Port of ``repro/analysis/invariants.py``, run over the port's own
spec-construction paths.  The degree-set enumeration
(:mod:`repro_torch.core.age`) is "correct by construction" — but three
other layers restate its consequences as arithmetic the runtime trusts:
the closed forms of :mod:`repro_torch.core.worker_counts` (Theorem 3,
Lemmas 4–7), the feasibility pruning of
:func:`repro_torch.mpc.autotune._feasible` (``st ≤ N``, ``N ≥ t²+z+2a``)
and the spec validation of :class:`repro_torch.mpc.api.MPCSpec` (the
verified-quorum gate).  A slip in any of them silently
corrupts decode or admits an unservable spec.  This pass proves, over the
Theorem-3 validation grid and every spec-construction path:

* **closed forms vs enumeration** — ``n_age_cmpc`` equals the enumerated
  minimum at every grid point, Γ(λ) matches cell-by-cell in the exact
  regimes (Υ₁/Υ₃/Υ₄/Υ₆/Υ₈ — the documented contract of
  tests/test_theorem3.py), and the baseline closed forms
  (``n_entangled_cmpc`` / ``n_polydot_cmpc``) are exact in their quoted
  regions and never under-count elsewhere;
* **decodability** — C1–C3 of eq. (5) and Theorem 1 hold for every
  enumerated code (``check_conditions`` / ``check_decodable``), and
  ``N ≥ t²+z`` (the recovery threshold is coverable);
* **construction paths** — every tuple :func:`~repro_torch.mpc.autotune.
  _feasible` yields satisfies its advertised inequalities; ``MPCSpec``
  accepts an adversary budget *iff* ``N ≥ t²+z+2a``; ``retune_spec``
  returns only survivor-servable divisors of the in-flight ``m``; and the
  elastic/replay escalation sources (``ElasticPool.retune``, the replay
  group's re-placement threshold) gate on the same verified quorum.

Everything is exact integer combinatorics — no protocol execution, no
arrays — so the pass is a static proof over the configuration space, not
a sampled test.
"""
from __future__ import annotations

import ast
import itertools
from typing import Dict, List

from .report import Finding

#: the Theorem-3 validation grid tests/test_theorem3.py pins (s, t, z);
#: t = 1 rows are covered separately through the Lemma 14 closed form
GRID_S = range(1, 7)
GRID_T = range(2, 7)
GRID_Z = range(1, 16)


class InvariantProofError(AssertionError):
    """A protocol invariant is violated somewhere in the proven space."""


def _fail(msg: str) -> None:
    raise InvariantProofError(msg)


# ----------------------------------------------------------- closed forms
#: regimes whose per-λ formula matches enumeration cell-by-cell; outside
#: them Υ₂/Υ₅/Υ₇/Υ₉ are documented as off-optimal-inexact (EXPERIMENTS.md
#: §Paper; tests/test_theorem3.py pins the same contract) — only the
#: headline ``min_λ Γ(λ)`` is exact everywhere
EXACT_REGIMES = frozenset({"U1", "U3", "U4", "U6", "U8"})


def _regime(s: int, t: int, z: int, lam: int) -> str:
    ts = t * s
    if lam == 0:
        return "U1" if z > ts - s else "U2"
    if lam == z:
        return "U3"
    q = min((z - 1) // lam, t - 1)
    if z > ts:
        return "U4"
    if ts < lam + s - 1:
        return "U5"
    if lam + s - 1 < z:
        return "U6" if q * lam >= s else "U7"
    return "U8" if q * lam >= s else "U9"


def prove_closed_forms() -> int:
    """Closed forms equal enumeration on the full Theorem-3 grid."""
    from ..core.age import AGECode, entangled_code, optimal_age_code, \
        polydot_code
    from ..core.worker_counts import (n_age_cmpc, n_entangled_cmpc,
                                      n_polydot_cmpc, gamma)

    checked = 0
    for s, t, z in itertools.product(GRID_S, GRID_T, GRID_Z):
        enum_n = optimal_age_code(s, t, z)[0].n_workers
        closed = n_age_cmpc(s, t, z)
        if enum_n != closed:
            _fail(f"n_age_cmpc({s},{t},{z})={closed} != enumerated "
                  f"{enum_n}")
        for lam in range(z + 1):
            if _regime(s, t, z, lam) not in EXACT_REGIMES:
                continue
            g = gamma(s, t, z, lam)
            e = AGECode(s, t, z, lam).n_workers
            if g != e:
                _fail(f"gamma({s},{t},{z},λ={lam})={g} != enumerated {e} "
                      f"(regime {_regime(s, t, z, lam)} is exact)")
        # Lemmas 4/7 quote baseline closed forms from [13]/[14]; they are
        # exact where the paper derives them and sound (never under-count)
        # upper bounds on the enumerated constructions elsewhere.
        ts = t * s
        ent = entangled_code(s, t, z).n_workers
        ent_c = n_entangled_cmpc(s, t, z)
        if z > ts - s and ent != ent_c:
            _fail(f"n_entangled_cmpc({s},{t},{z})={ent_c} != enumerated "
                  f"{ent} in the quoted z > ts-s region")
        if ent_c < ent:
            _fail(f"n_entangled_cmpc({s},{t},{z})={ent_c} under-counts "
                  f"the enumerated construction ({ent})")
        poly = polydot_code(s, t, z).n_workers
        poly_c = n_polydot_cmpc(s, t, z)
        quoted = (s == 1 and z > t) or (s != 1 and z > ts)
        if quoted and poly != poly_c:
            _fail(f"n_polydot_cmpc({s},{t},{z})={poly_c} != enumerated "
                  f"{poly} in a quoted Lemma-7 region")
        if poly_c < poly:
            _fail(f"n_polydot_cmpc({s},{t},{z})={poly_c} under-counts "
                  f"the enumerated construction ({poly})")
        checked += 1
    # Lemma 14: t = 1 collapses every scheme to 2s + 2z − 1
    from ..core.worker_counts import n_age_cmpc as n_age
    for s, z in itertools.product(range(2, 9), range(1, 9)):
        expect = 2 * s + 2 * z - 1
        got = n_age(s, 1, z, closed_form=False)
        if got != expect:
            _fail(f"t=1 enumeration N={got} != 2s+2z-1={expect} "
                  f"(s={s}, z={z})")
        checked += 1
    return checked


# ----------------------------------------------------------- decodability
def prove_decodability() -> int:
    """C1–C3 + Theorem 1 + the recovery-threshold floor, every code."""
    from ..mpc.planner import _resolve_code

    checked = 0
    schemes = ("age", "entangled", "polydot")
    for s, t, z in itertools.product(GRID_S, GRID_T, GRID_Z):
        for scheme in schemes:
            lams = range(z + 1) if scheme == "age" else (None,)
            for lam in lams:
                code = _resolve_code(scheme, s, t, z, lam)
                code.check_conditions()     # C1–C3 (raises InvariantError)
                code.check_decodable()      # Theorem 1 (i) + (ii)
                if code.n_workers < t * t + z:
                    _fail(f"{scheme}(s={s},t={t},z={z},λ={lam}): "
                          f"N={code.n_workers} < recovery threshold "
                          f"t²+z={t * t + z}")
                checked += 1
    return checked


# ---------------------------------------------------- construction paths
def prove_feasible_path(budget: int = 256,
                        z_range=None,
                        a_range=(0, 1, 2)) -> int:
    """Every tuple the tuner's enumeration yields honors its contract."""
    from ..mpc.autotune import MAX_PARTITION, _feasible
    from ..mpc.planner import _resolve_code

    z_range = range(1, 6) if z_range is None else z_range

    axis = range(1, MAX_PARTITION + 1)
    checked = 0
    for z in z_range:
        for a in a_range:
            for scheme, s, t, lam, n in _feasible(
                    budget, z, ("age", "entangled", "polydot"),
                    axis, axis, None, a):
                if (s, t) == (1, 1):
                    _fail("feasible path emitted the uncoded s=t=1 case")
                if s * t > n:
                    _fail(f"{scheme}(s={s},t={t}): st={s * t} > N={n}")
                if n > budget:
                    _fail(f"{scheme}(s={s},t={t},z={z}): N={n} over "
                          f"budget {budget}")
                if n < t * t + z + 2 * a:
                    _fail(f"{scheme}(s={s},t={t},z={z},a={a}): N={n} < "
                          f"verified quorum {t * t + z + 2 * a}")
                if lam is not None and not 0 <= lam <= z:
                    _fail(f"gap λ={lam} outside [0, z={z}]")
                if _resolve_code(scheme, s, t, z, lam).n_workers != n:
                    _fail(f"{scheme}(s={s},t={t},z={z},λ={lam}): yielded "
                          f"N={n} disagrees with the code")
                checked += 1
    return checked


def prove_spec_gate(z_range=None, a_range=(0, 1, 2, 3)) -> int:
    """``MPCSpec`` accepts an adversary budget iff ``N ≥ t²+z+2a``."""
    from ..mpc.api import MPCSpec
    from ..mpc.planner import _resolve_code

    z_range = range(1, 6) if z_range is None else z_range

    checked = 0
    for s, t in itertools.product(range(1, 5), range(1, 5)):
        if (s, t) == (1, 1):
            continue
        for z in z_range:
            n = _resolve_code("age", s, t, z, None).n_workers
            for a in a_range:
                ok_expected = a == 0 or n >= t * t + z + 2 * a
                try:
                    spec = MPCSpec(s=s, t=t, z=z, adversaries=a)
                    ok_got = True
                except ValueError:
                    ok_got = False
                if ok_got != ok_expected:
                    _fail(f"MPCSpec(s={s},t={t},z={z},a={a}): gate "
                          f"{'accepted' if ok_got else 'rejected'} but "
                          f"N={n} vs quorum {t * t + z + 2 * a} says "
                          f"{'accept' if ok_expected else 'reject'}")
                if ok_got and spec.verified_threshold != t * t + z + 2 * a:
                    _fail(f"verified_threshold mismatch at "
                          f"(s={s},t={t},z={z},a={a})")
                checked += 1
    return checked


def prove_retune_path(m: int = 24, z: int = 2,
                      a_range=(0, 1)) -> int:
    """``retune_spec`` only returns survivor-servable divisors of ``m``."""
    from ..mpc.autotune import retune_spec

    checked = 0
    for a in a_range:
        for survivors in range(1, 40):
            spec = retune_spec(survivors, z, m=m, adversaries=a)
            if spec is None:
                continue
            if m % spec.s or m % spec.t:
                _fail(f"retune_spec(m={m}) returned s={spec.s}, "
                      f"t={spec.t}: not divisors of m")
            if spec.n_workers > survivors:
                _fail(f"retune_spec: N={spec.n_workers} exceeds the "
                      f"{survivors} survivors")
            if spec.n_workers < spec.t ** 2 + z + 2 * a:
                _fail(f"retune_spec: N={spec.n_workers} below the "
                      f"verified quorum at a={a}")
            checked += 1
    return checked


# ------------------------------------------------- escalation-source audit
#: both modules restate the verified quorum instead of importing it; the
#: normalized (receiver-stripped) expression must keep appearing verbatim
_QUORUM_NEEDLE = "t * t + z + 2 * adversaries"
_QUORUM_SOURCES = ("repro_torch/mpc/elastic.py", "repro_torch/sim/replay.py")


def audit_escalation_sources(src_root: str = "src") -> int:
    """The elastic/replay escalation layers still gate on ``t²+z+2a``.

    These two modules *re-derive* the quorum instead of importing it (the
    elastic pool works on raw protocol objects, the replay on specs), so
    the prover pins the expression itself: normalize each module's AST
    and require the quorum arithmetic to appear.  Editing either to a
    weaker inequality breaks this proof before it can break a fleet.
    """
    import os

    checked = 0
    for rel in _QUORUM_SOURCES:
        path = os.path.join(src_root, rel)
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError) as e:
            _fail(f"cannot audit {path}: {e}")
        found = False
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp):
                try:
                    text = ast.unparse(node)
                except Exception:       # analysis: allow(*): best-effort
                    continue
                for recv in ("self.", "proto.", "spec.", "code."):
                    text = text.replace(recv, "")
                if _QUORUM_NEEDLE in text:
                    found = True
                    break
        if not found:
            _fail(f"{path}: verified-quorum expression "
                  f"{_QUORUM_NEEDLE!r} is gone — the escalation path no "
                  f"longer gates on t²+z+2a")
        checked += 1
    return checked


def run(src_root: str = "src") -> Dict[str, int]:
    """Run every proof; raises :class:`InvariantProofError` on failure."""
    return {
        "closed_forms": prove_closed_forms(),
        "decodability": prove_decodability(),
        "feasible_path": prove_feasible_path(),
        "spec_gate": prove_spec_gate(),
        "retune_path": prove_retune_path(),
        "escalation_sources": audit_escalation_sources(src_root),
    }


def as_findings(src_root: str = "src") -> List[Finding]:
    """CLI adapter: one finding per failed proof (empty when all hold)."""
    try:
        run(src_root)
    except InvariantProofError as e:
        return [Finding(rule="invariant", file=src_root, line=1,
                        message=str(e), snippet=str(e))]
    return []

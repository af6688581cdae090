"""AGE code degree-set construction (paper §IV-A, Theorems 1 and 2).

Everything here is exact integer combinatorics over *degree sets* (sets of
polynomial powers with non-zero coefficients).  The executable finite-field
protocol lives in :mod:`repro.mpc.protocol`; this module answers the
combinatorial questions the paper proves theorems about:

* ``P(C_A)``, ``P(C_B)``      -- coded-term powers, eq. (3)-(4)
* ``P(S_A)``, ``P(S_B)``      -- secret-term powers, eq. (6)-(7) / Thm 2
* important powers            -- ``(s-1)α + iβ + θl``
* ``P(H(x))``                 -- all powers of ``F_A·F_B`` (workers needed)

The construction is implemented through the *generalized* polynomial code
family of eq. (2) with parameters ``(alpha, beta, theta)`` so that AGE
(``(1, s, ts+λ)``), Entangled (``(1, s, ts)``) and PolyDot
(``(t, 1, t(2s-1))``) all share one code path; the paper's closed forms are
cross-validated against this enumeration in ``tests/``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import FrozenSet, Tuple


def _sumset(a, b) -> FrozenSet[int]:
    return frozenset(x + y for x in a for y in b)


@dataclasses.dataclass(frozen=True)
class GeneralizedPolyCode:
    """Generalized entangled polynomial code of eq. (2) with MPC secret terms.

    ``A^T`` is partitioned into ``t`` row-blocks x ``s`` col-blocks
    (``A_{i,j} ∈ F^{m/t × m/s}``), ``B`` into ``s`` row-blocks x ``t``
    col-blocks.  ``z`` is the collusion bound.  Secret-term degree sets follow
    the paper's strategy (§IV-B): ``P(S_B)`` sits directly above the largest
    important power; ``P(S_A)`` greedily takes the ``z`` smallest non-negative
    powers satisfying condition C2 of eq. (5).
    """

    s: int
    t: int
    z: int
    alpha: int
    beta: int
    theta: int

    def __post_init__(self):
        if self.s < 1 or self.t < 1:
            raise ValueError(f"need s,t >= 1, got s={self.s} t={self.t}")
        if self.z < 1:
            raise ValueError(f"need z >= 1 colluding workers, got z={self.z}")
        if self.s == 1 and self.t == 1:
            # Footnote 1: s=t=1 is plain BGW, excluded from coded MPC.
            raise ValueError("s=t=1 is the uncoded BGW case (paper footnote 1)")

    # ------------------------------------------------------------------ coded
    @cached_property
    def coded_powers_a(self) -> FrozenSet[int]:
        """P(C_A(x)) -- eq. (3) in the generalized form ``jα + iβ``."""
        return frozenset(
            j * self.alpha + i * self.beta
            for i in range(self.t)
            for j in range(self.s)
        )

    @cached_property
    def coded_powers_b(self) -> FrozenSet[int]:
        """P(C_B(x)) -- eq. (4): ``(s-1-k)α + θl``."""
        return frozenset(
            (self.s - 1 - k) * self.alpha + self.theta * l
            for k in range(self.s)
            for l in range(self.t)
        )

    @cached_property
    def important_powers(self) -> FrozenSet[int]:
        """Powers carrying ``Y_{i,l} = Σ_j A_{ij}B_{jl}`` (the j=k diagonal)."""
        return frozenset(
            (self.s - 1) * self.alpha + i * self.beta + self.theta * l
            for i in range(self.t)
            for l in range(self.t)
        )

    # ----------------------------------------------------------------- secret
    @cached_property
    def secret_powers_b(self) -> FrozenSet[int]:
        """P(S_B(x)): z consecutive powers from max(important)+1 -- eq. (7)."""
        start = max(self.important_powers) + 1
        return frozenset(range(start, start + self.z))

    @cached_property
    def secret_powers_a(self) -> FrozenSet[int]:
        """P(S_A(x)): greedy z smallest powers satisfying C2 -- Thm 2.

        C2: ``imp ∉ P(S_A) + P(C_B)``  ⇔  ``P(S_A) ∩ (imp - P(C_B)) = ∅``.
        (C1 and C3 hold automatically given ``P(S_B)`` starts past the largest
        important power and all powers are non-negative -- Appendix B.)
        """
        forbidden = {
            imp - c
            for imp in self.important_powers
            for c in self.coded_powers_b
        }
        out, x = [], 0
        while len(out) < self.z:
            if x not in forbidden:
                out.append(x)
            x += 1
        return frozenset(out)

    # ------------------------------------------------------------------- H(x)
    @cached_property
    def powers_f_a(self) -> FrozenSet[int]:
        return self.coded_powers_a | self.secret_powers_a

    @cached_property
    def powers_f_b(self) -> FrozenSet[int]:
        return self.coded_powers_b | self.secret_powers_b

    @cached_property
    def powers_h(self) -> FrozenSet[int]:
        """P(H(x)) = D1 ∪ D2 ∪ D3 ∪ D4 -- eq. (39)-(43)."""
        d1 = _sumset(self.coded_powers_a, self.coded_powers_b)
        d2 = _sumset(self.coded_powers_a, self.secret_powers_b)
        d3 = _sumset(self.secret_powers_a, self.coded_powers_b)
        d4 = _sumset(self.secret_powers_a, self.secret_powers_b)
        return d1 | d2 | d3 | d4

    @cached_property
    def n_workers(self) -> int:
        """Required number of workers = |P(H(x))| (Appendix C)."""
        return len(self.powers_h)

    @property
    def recovery_threshold(self) -> int:
        """Master needs I(α_n) from t² + z workers (Phase 3)."""
        return self.t * self.t + self.z

    # -------------------------------------------------------------- validity
    def check_conditions(self) -> None:
        """Assert C1-C3 of eq. (5) hold (garbage never hits important powers)."""
        # lazy: repro.mpc.planner imports this module at package init
        from ..mpc.errors import InvariantError

        imp = self.important_powers
        c1 = _sumset(self.coded_powers_a, self.secret_powers_b)
        c2 = _sumset(self.secret_powers_a, self.coded_powers_b)
        c3 = _sumset(self.secret_powers_a, self.secret_powers_b)
        for name, clash in (("C1", imp & c1), ("C2", imp & c2),
                            ("C3", imp & c3)):
            if clash:
                raise InvariantError(
                    f"{name} violated for {self!r}: garbage powers "
                    f"{sorted(clash)[:4]} hit important powers")

    def check_decodable(self) -> None:
        """Theorem 1: important powers are distinct and untouched by garbage.

        (i) |important| == t² and (ii) no overlap between the j=k diagonal
        terms and the j≠k cross terms of ``C_A·C_B``.
        """
        from ..mpc.errors import InvariantError

        imp = self.important_powers
        if len(imp) != self.t * self.t:
            raise InvariantError(
                f"important powers collide (Thm 1 i) for {self!r}: "
                f"|imp|={len(imp)} != t²={self.t * self.t}")
        cross = frozenset(
            j * self.alpha + i * self.beta
            + (self.s - 1 - k) * self.alpha + self.theta * l
            for i in range(self.t)
            for l in range(self.t)
            for j in range(self.s)
            for k in range(self.s)
            if j != k
        )
        if imp & cross:
            raise InvariantError(
                f"garbage overlaps important powers (Thm 1 ii) for "
                f"{self!r}: {sorted(imp & cross)[:4]}")


# --------------------------------------------------------------------- AGE --
@dataclasses.dataclass(frozen=True)
class AGECode(GeneralizedPolyCode):
    """AGE code: ``(α, β, θ) = (1, s, ts + λ)`` with gap ``0 ≤ λ ≤ z``."""

    lam: int = 0

    def __init__(self, s: int, t: int, z: int, lam: int):
        if not 0 <= lam <= z:
            raise ValueError(f"need 0 <= λ <= z, got λ={lam} z={z}")
        object.__setattr__(self, "lam", lam)
        super().__init__(s=s, t=t, z=z, alpha=1, beta=s, theta=t * s + lam)

    # Closed-form secret powers of eq. (6)/(34)-(36), used to cross-check the
    # greedy construction (they must agree -- tested in tests/test_age_sets.py).
    def secret_powers_a_closed_form(self) -> FrozenSet[int]:
        s, t, z, lam, theta = self.s, self.t, self.z, self.lam, self.theta
        ts = t * s
        if t == 1:
            return frozenset(s + u for u in range(z))            # eq. (36)
        if z == lam:
            return frozenset(ts + u for u in range(z))           # eq. (35)
        if lam == 0:
            # Entangled limit: every finite gap interval of eq. (30) is empty.
            return frozenset(ts + theta * (t - 1) + u for u in range(z))
        q = min((z - 1) // lam, t - 1)
        head = {ts + theta * l + w for l in range(q) for w in range(lam)}
        tail = {ts + theta * q + u for u in range(z - q * lam)}  # eq. (34)
        return frozenset(head | tail)


def entangled_code(s: int, t: int, z: int) -> AGECode:
    """Entangled-CMPC [14] == AGE with λ = 0 (paper, Lemma 16/17 proofs)."""
    return AGECode(s, t, z, lam=0)


def polydot_code(s: int, t: int, z: int) -> GeneralizedPolyCode:
    """PolyDot-CMPC [13]: ``(α, β, θ) = (t, 1, t(2s-1))`` + same secret recipe."""
    return GeneralizedPolyCode(
        s=s, t=t, z=z, alpha=t, beta=1, theta=t * (2 * s - 1)
    )


def optimal_age_code(s: int, t: int, z: int) -> Tuple[AGECode, int]:
    """Solve ``min_λ |P(H)|`` by exact enumeration; return (code, λ*).

    Ties break toward the *largest* λ (matches the paper's Example 1 where
    s=t=z=2 yields λ*=2 with N=17).
    """
    best: Tuple[AGECode, int] | None = None
    for lam in range(z + 1):
        code = AGECode(s, t, z, lam)
        if best is None or code.n_workers <= best[0].n_workers:
            best = (code, lam)
    if best is None:
        from ..mpc.errors import InvariantError
        raise InvariantError(f"no AGE gap in [0, z={z}] produced a code")
    return best

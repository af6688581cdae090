"""Prime-field arithmetic on torch tensors (port of ``repro/mpc/field.py``).

Default field: ``p = 2²⁶ − 5`` (prime).  Products fit int64 with headroom
for *chunked accumulation*: ``(p−1)² < 2⁵²``, so up to ``2¹¹ = 2048``
products can be summed in int64 before a modular fold.  That
"chunk-then-fold" window (:func:`acc_window`) is the contract the CUDA
kernels (:mod:`repro_torch.kernels.modmatmul`,
:mod:`repro_torch.kernels.polyeval`) fold at.

``p = 2³¹ − 1`` (Mersenne-31) is also supported; its window is 2.

Field elements are int64 tensors with values in ``[0, p)``.  Every op here
runs on whatever device its operands live on; ``random`` draws on the
generator's device.
"""
from __future__ import annotations

import dataclasses

import torch

from .errors import InvariantError

P_DEFAULT = 2**26 - 5      # prime; (p-1)^2 * 2048 < 2^63
P_MERSENNE31 = 2**31 - 1   # prime; window 2


def acc_window(p: int) -> int:
    """Exact int64 chunk-then-fold window for ``F_p``.

    The largest ``q`` such that ``q·(p−1)² + (p−1) < 2⁶³``: a modular
    accumulator (``< p``) plus ``q`` raw products can never overflow int64.
    The single source of the accumulation contract: the kernels' fold
    cadence and the plain ops' chunk size both derive from it.
    """
    return max(1, (2**63 - p) // ((p - 1) ** 2))


ACC_WINDOW = {P_DEFAULT: acc_window(P_DEFAULT),
              P_MERSENNE31: acc_window(P_MERSENNE31)}
if ACC_WINDOW[P_DEFAULT] != 2048:  # the documented p = 2²⁶−5 contract
    raise InvariantError(
        f"acc_window(P_DEFAULT) = {ACC_WINDOW[P_DEFAULT]}, expected 2048: "
        f"the chunk-then-fold contract the kernels are built around")


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % q == 0:
            return n == q
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


if not (is_prime(P_DEFAULT) and is_prime(P_MERSENNE31)):
    raise InvariantError("a shipped field modulus is composite")


def as_int64(x, device=None) -> torch.Tensor:
    """``x`` (tensor, array or scalar) as an int64 tensor on ``device``
    (default: where it is).  Host data is copied, never aliased."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x)
    return x.to(device=device, dtype=torch.int64)


# ------------------------------------------------------- devices and keys
def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` when given; otherwise the card.  With no card, ``None`` or
    a CUDA device raises: the port never quietly runs on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the port on "
            "the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_MASK64 = (1 << 64) - 1


def fold_in(key, data: int) -> int:
    """A new 63-bit seed from a base key and an integer (per-block keys).

    ``key`` is an int seed or a ``torch.Generator`` (its initial seed);
    a splitmix64 finalizer mixes the pair, so nearby ``(key, data)``
    pairs give unrelated streams.
    """
    seed = key.initial_seed() if isinstance(key, torch.Generator) else int(key)
    x = (seed * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def generator(key, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` from an int seed, or ``key``
    itself when it already is a generator on that device; None on
    ``meta``, where shapes are traced and nothing is drawn."""
    if torch.device(device).type == "meta":
        return None     # a meta tensor holds no numbers to draw
    if isinstance(key, torch.Generator):
        if torch.device(key.device).type != torch.device(device).type:
            raise ValueError(
                f"generator on {key.device} cannot draw for {device}")
        return key
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


@dataclasses.dataclass(frozen=True)
class Field:
    """A prime field F_p with fixed-point encode/decode for real data."""

    p: int = P_DEFAULT
    frac_bits: int = 8  # fixed-point fractional bits for float <-> field

    def __post_init__(self):
        if not is_prime(self.p):
            raise ValueError(f"{self.p} is not prime")

    # ----------------------------------------------------------- modular ops
    def add(self, a, b):
        return torch.remainder(as_int64(a) + as_int64(b), self.p)

    def sub(self, a, b):
        return torch.remainder(as_int64(a) - as_int64(b), self.p)

    def mul(self, a, b):
        return torch.remainder(as_int64(a) * as_int64(b), self.p)

    def neg(self, a):
        return torch.remainder(-as_int64(a), self.p)

    def pow_scalar(self, base: int, exp: int) -> int:
        return pow(int(base) % self.p, int(exp), self.p)

    def inv_scalar(self, a: int) -> int:
        a = int(a) % self.p
        if a == 0:
            raise ZeroDivisionError("0 has no inverse")
        return pow(a, self.p - 2, self.p)

    # ------------------------------------------------------------ mod matmul
    def matmul(self, a, b, *, chunk: int | None = None):
        """Exact ``(a @ b) mod p`` with chunk-then-fold accumulation.

        ``a: [..., M, K]``, ``b: [..., K, N]`` int64 field elements.  On
        the CPU, :func:`~repro_torch.kernels.barrett.matmul_folded` folds
        every ``chunk`` (default :func:`acc_window`) products; CUDA has no
        int64 matmul, so a CUDA tensor takes the exact float64 limb GEMMs.
        """
        # lazy: the kernels package imports this module
        from ..kernels.barrett import matmul_folded, matmul_limbs

        a, b = as_int64(a), as_int64(b)
        if a.device.type != "cpu":
            return matmul_limbs(a, b, p=self.p)
        return matmul_folded(a, b, p=self.p, window=chunk or acc_window(self.p))

    # ---------------------------------------------------------- fixed point
    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def half(self) -> int:
        return self.p // 2

    def encode(self, x):
        """Real -> field, two's-complement style: [-p/2, p/2) ↦ [0, p).

        ``torch.round`` rounds half to even, as ``jnp.round`` does."""
        x = torch.as_tensor(x).to(torch.float64)
        q = torch.round(x * self.scale).to(torch.int64)
        return torch.remainder(q, self.p)

    def decode(self, a, *, products: int = 1):
        """Field -> real.  ``products`` = #fixed-point multiplications folded
        into the value (each adds ``frac_bits`` of scale)."""
        a = torch.remainder(as_int64(a), self.p)
        signed = torch.where(a > self.half, a - self.p, a)
        return signed.to(torch.float64) / float(self.scale ** products)

    # --------------------------------------------------------------- random
    def random(self, generator: torch.Generator, shape):
        """Uniform field elements (secret masks), drawn on the generator's
        device."""
        return torch.randint(0, self.p, tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.int64)


DEFAULT_FIELD = Field()

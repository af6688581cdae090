"""Plain reference of a private matmul: the decoded product of the
fixed-point operands, worked out again from the float operands.

The configuration states what a private product returns: each operand
encoded as ``round(x * 2^f)`` (half to even), the integer product reduced
mod p into ``(-p/2, p/2]``, and scaled back by ``2^-2f`` into the
operands' dtype.  Here that is a float64 matrix product of the encoded
integers, exact while every partial sum stays below 2^53 (checked), in
blocks of rows so that it fits beside the operands.

``precision="bfloat16"`` is the control: the same steps with the encoded
operands rounded to bfloat16 before an fp32-accumulated product, as a
tensor-core GEMM in place of the field arithmetic would take them.
``precision="tf32"`` takes them in float32 with TF32 allowed, the step
below float32; on this configuration's operands (encoded integers below
2^11, partial sums below 2^24) it is exact, so it cannot serve as the
control.
"""
from __future__ import annotations

import torch

EXACT_LIMIT = 2.0 ** 53


class _tf32:
    """TF32 allowed for float32 matrix products inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


def encode(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """``round(x * 2^f)`` in float64 (``torch.round`` rounds half to even)."""
    return torch.round(x.to(torch.float64) * float(1 << frac_bits))


def centered_mod(y: torch.Tensor, p: int) -> torch.Tensor:
    """Integers (float64, exact) reduced mod p into ``(-p/2, p/2]``."""
    r = torch.remainder(y, float(p))
    return torch.where(r > p // 2, r - p, r)


def product(a: torch.Tensor, b: torch.Tensor, *, p: int, frac_bits: int,
            precision: str = "float64", rows: int = 256,
            out_dtype=torch.float32) -> torch.Tensor:
    """The decoded private product ``a @ b`` (``[r, k] x [k, c]``)."""
    qa, qb = encode(a, frac_bits), encode(b, frac_bits)
    bound = float(qa.abs().max()) * float(qb.abs().max()) * a.shape[-1]
    if precision == "float64" and bound >= EXACT_LIMIT:
        raise ValueError(f"partial sums up to {bound:.3e} are not exact in "
                         "float64")
    low = {"bfloat16": torch.bfloat16, "tf32": torch.float32}.get(precision)
    if low is not None:
        qb = qb.to(low).to(torch.float32)
    elif precision != "float64":
        raise ValueError(f"unknown precision {precision!r}")
    scale = float(1 << (2 * frac_bits))
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    for r0 in range(0, a.shape[0], rows):
        blk = qa[r0:r0 + rows]
        if low is not None:
            blk = blk.to(low).to(torch.float32)
            with _tf32(precision == "tf32"):
                y = torch.round((blk @ qb).to(torch.float64))
        else:
            y = blk @ qb
        out[r0:r0 + rows] = (centered_mod(y, p) / scale).to(out_dtype)
    return out

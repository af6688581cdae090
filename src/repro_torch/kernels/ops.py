"""Public dispatchers for the kernels, beside their oracles.

Port of ``repro/kernels/ops.py``.  ``use_kernel`` (the reference's
``use_pallas``) is the caller's explicit choice between the kernel's
wrapper, which launches the CUDA kernel on a CUDA tensor and takes its
plain version on a CPU tensor, and the oracle of :mod:`.ref`.  Neither
falls back to the other.  The Pallas block sizes and ``interpret`` flag
have no counterpart: the kernels size their own tiles.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention
from .modmatmul import modmatmul
from .polyeval import polyeval
from .rwkv6 import rwkv6


def mod_matmul(a, b, *, p: int, use_kernel: bool = False):
    """Finite-field matmul (phase-2 hot loop)."""
    if use_kernel:
        return modmatmul(a, b, p=p)
    return ref.modmatmul_ref(a, b, p=p)


def poly_eval(vand, terms, *, p: int, use_kernel: bool = False):
    """Share evaluation F[n] = Σ_k V[n,k]·T[k] mod p (phases 1-2)."""
    if use_kernel:
        return polyeval(vand, terms, p=p)
    return ref.polyeval_ref(vand, terms, p=p)


def attention(q, k, v, *, causal: bool = True, use_kernel: bool = False):
    """GQA attention: the flash kernel (causal mask aligned top-left, as
    the Pallas kernel's) or the oracle (aligned bottom-right); the two
    agree where T == S."""
    if use_kernel:
        return flash_attention(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)


def wkv6(r, k, v, w, u, *, use_kernel: bool = False):
    """RWKV-6 recurrence: the WKV kernel or the step oracle; ``[B,T,H,V]``
    fp32 either way."""
    if use_kernel:
        return rwkv6(r, k, v, w, u)[0]
    return ref.rwkv6_ref(r, k, v, w, u)

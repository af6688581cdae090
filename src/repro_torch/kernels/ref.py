"""Plain torch oracles for every kernel: the twins of ``repro/kernels/ref.py``.

Each function takes and returns what its JAX counterpart does.  Where a
kernel's plain version already computes the same function it is that
plain version, so the port keeps one oracle per kernel:

* ``modmatmul_ref``, ``modmatmul_batched_ref``, ``polyeval_ref`` — exact
  ``(a @ b) mod p`` (:func:`~repro_torch.kernels.modmatmul.modmatmul_plain`,
  batched over leading dims);
* ``rwkv6_ref``, ``rwkv6_scan_with_state``, ``rwkv6_chunked`` — the WKV-6
  recurrence (:func:`~repro_torch.kernels.rwkv6.rwkv6_plain`, which
  returns the final state too).  The reference's chunked form is another
  schedule of the same function, so ``chunk`` changes only its rounding
  there and nothing here;
* ``flash_attention_ref`` — softmax attention with the causal mask
  aligned bottom-right, as the reference aligns it
  (:func:`~repro_torch.kernels.flash_attention.flash_attention_plain` at
  ``q_offset = S - T``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_plain
from .modmatmul import modmatmul_plain
from .rwkv6 import rwkv6_plain


def modmatmul_ref(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """Exact ``(a @ b) mod p`` of field elements (int64)."""
    return modmatmul_plain(a.to(torch.int64), b.to(torch.int64), p=p)


def modmatmul_batched_ref(a: torch.Tensor, b: torch.Tensor, *,
                          p: int) -> torch.Tensor:
    """Per-worker ``(a[w] @ b[w]) mod p`` oracle for the batched kernel."""
    return modmatmul_ref(a, b, p=p)


def polyeval_ref(vand: torch.Tensor, terms: torch.Tensor, *,
                 p: int) -> torch.Tensor:
    return modmatmul_ref(vand, terms, p=p)


def rwkv6_scan_with_state(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """Like :func:`rwkv6_ref` but also returns the final [B,H,K,V] state
    (serving prefill needs it to seed decode)."""
    return rwkv6_plain(r, k, v, w, u, state0=state0)


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, return_state: bool = False):
    """The reference's chunked-parallel WKV, mathematically identical to
    :func:`rwkv6_ref`; ``chunk`` must be positive and picks the reference's
    schedule only."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out, state = rwkv6_plain(r, k, v, w, u)
    return (out, state) if return_state else out


def rwkv6_ref(r, k, v, w, u) -> torch.Tensor:
    """RWKV-6 (Finch) WKV recurrence, data-dependent decay — arXiv:2404.05892.

    Shapes: r,k,w: [B, T, H, K]; v: [B, T, H, V]; u: [H, K].
    Returns [B, T, H, V] (fp32).
    """
    return rwkv6_plain(r, k, v, w, u)[0]


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention with GQA head broadcasting.

    q: [B, T, Hq, D]; k,v: [B, S, Hkv, D]; Hq % Hkv == 0.  Causal row ``i``
    sees keys ``j <= i + S - T`` (the mask aligned bottom-right).
    """
    return flash_attention_plain(q, k, v, causal=causal,
                                 q_offset=k.shape[1] - q.shape[1], scale=scale)

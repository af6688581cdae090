"""Share evaluation on the card: the protocol's skinny-K table products.

Computes ``F[n, :] = (Σ_k V[n, k] · T[k, :]) mod p``: a tiny table
``V [N, K]`` (Vandermonde rows, the G-mix, decode rows) against long rows
``T [K, C]`` (flattened blocks).  Port of ``repro/kernels/polyeval.py``;
it serves phase-1 shares (K = ts+z), the phase-2 exchange (K = N and
K = z) and phase-3 decode (K = t²+z).

The CUDA kernel (``csrc/polyeval.cu``) streams each column of ``T`` once
with the rows of ``V`` in shared memory and folds every ``acc_window(p)``
products, so unlike the Pallas kernel it takes any K and serves M31.

The wrapper checks its operands, allocates the output with
``torch.empty``, launches on the current stream and counts the launch in
``polyeval.launches``.  A CPU tensor takes the plain version
(:func:`polyeval_plain`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..mpc.errors import ShapeContractError
from ..mpc.field import acc_window
from . import _build
from .barrett import matmul_plain


def polyeval_plain(vand: torch.Tensor, terms: torch.Tensor, *,
                   p: int) -> torch.Tensor:
    """The plain version: exact ``(vand @ terms) mod p`` from the barrett
    ops, on any device."""
    return matmul_plain(vand, terms, p=p, window=acc_window(p))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("polyeval")
    fn = lib.polyeval_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def polyeval(vand: torch.Tensor, terms: torch.Tensor, *, p: int) -> torch.Tensor:
    """``vand: [N, K]``, ``terms: [K, C]`` contiguous int64 field elements
    (< p) on one device; returns ``[N, C]`` int64.  Any K, either prime."""
    for x in (vand, terms):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f"polyeval takes int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
        if not x.is_contiguous():
            raise ValueError("polyeval takes contiguous operands")
    if vand.ndim != 2 or terms.ndim != 2 or vand.shape[1] != terms.shape[0]:
        raise ShapeContractError(
            f"polyeval needs vand [N,K] @ terms [K,C]: got "
            f"{tuple(vand.shape)} and {tuple(terms.shape)}",
            shapes=(vand.shape, terms.shape))
    if vand.device != terms.device:
        raise ValueError(f"polyeval operands on {vand.device} and "
                         f"{terms.device}")
    if vand.device.type == "cpu":
        return polyeval_plain(vand, terms, p=p)
    if vand.device.type != "cuda":
        raise ValueError(f"polyeval runs on cpu or cuda, not {vand.device}")
    n, k = vand.shape
    c = terms.shape[1]
    args = _build.fold_args(p)
    out = torch.empty((n, c), dtype=torch.int64, device=vand.device)
    with torch.cuda.device(vand.device):
        stream = torch.cuda.current_stream(vand.device).cuda_stream
        err = _lib()(vand.data_ptr(), terms.data_ptr(), out.data_ptr(),
                     n, k, c, *args, stream)
    _build.check(err, "polyeval")
    polyeval.launches += 1
    return out


polyeval.launches = 0

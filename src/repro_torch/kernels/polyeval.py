"""Share evaluation on the card: the protocol's skinny-K table products.

Computes ``F[n, :] = (Σ_k V[n, k] · T[k, :]) mod p``: a tiny table
``V [N, K]`` (Vandermonde rows, the G-mix beside the mask table, decode
rows) against long rows ``T [K, C]`` (flattened blocks).  Port of
``repro/kernels/polyeval.py``; it serves phase-1 shares (K = ts+z), the
phase-2 exchange (K = N + z, the mask term folded in) and phase-3 decode
(K = t²+z).

``T`` comes in one of three forms, none of which the stages copy first:

* one tensor ``[K, C]`` (encode);
* one tensor ``[R, C]`` and ``rows``, a device int64 index of length K:
  ``T = terms[rows]`` (decode: the survivors' I-points);
* two tensors ``[K1, C]`` and ``[K2, C]``, stacked (the exchange: the
  H-points, then the aggregate mask).

Rows need unit column stride; their row stride is read as it is.

The CUDA kernel (``csrc/polyeval.cu``) is a persistent, warp-specialized
stream: a producer warp bulk-copies row segments into a ring of shared
memory stages while eight consumer warps multiply-accumulate and fold
every ``acc_window(p)`` products, so it takes any N and K and serves M31.
The index is read on the device; the wrapper builds nothing on the host
per launch.

The wrapper checks its operands, allocates the output with
``torch.empty``, launches on the current stream and counts the launch in
``polyeval.launches``.  A CPU tensor takes the plain version
(:func:`polyeval_plain`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from ..mpc.errors import ShapeContractError
from ..mpc.field import acc_window
from . import _build
from .barrett import matmul_plain

Terms = Union[torch.Tensor, Sequence[torch.Tensor]]


def _sources(terms: Terms) -> Tuple[torch.Tensor, ...]:
    return (terms,) if isinstance(terms, torch.Tensor) else tuple(terms)


def stacked_terms(terms: Terms, rows: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``T [K, C]`` as the kernel reads it: ``terms[rows]`` for an index,
    the sources stacked for a pair, the tensor itself otherwise."""
    srcs = _sources(terms)
    if rows is not None:
        return srcs[0].index_select(0, rows)
    return srcs[0] if len(srcs) == 1 else torch.cat(srcs)


def polyeval_plain(vand: torch.Tensor, terms: Terms, *, p: int,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: exact ``(vand @ T) mod p`` from the barrett ops,
    on any device, for every form of ``terms``."""
    return matmul_plain(vand, stacked_terms(terms, rows), p=p,
                        window=acc_window(p))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("polyeval")
    fn = lib.polyeval_launch
    source = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_int]
    fn.argtypes = ([ctypes.c_void_p] + source + source
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(vand, srcs, rows) -> int:
    """Validates the operands; returns K."""
    for x in (vand,) + srcs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f"polyeval takes int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
    if not 1 <= len(srcs) <= 2:
        raise ShapeContractError(
            f"polyeval takes one or two term tensors, got {len(srcs)}",
            shapes=tuple(x.shape for x in srcs))
    shapes = (vand.shape,) + tuple(x.shape for x in srcs)
    if vand.ndim != 2 or any(x.ndim != 2 for x in srcs):
        raise ShapeContractError(
            f"polyeval needs vand [N,K] and terms [K_i,C]: got {shapes}",
            shapes=shapes)
    if not vand.is_contiguous():
        raise ValueError("polyeval takes a contiguous vand")
    if any(x.stride(1) != 1 and x.numel() > 0 for x in srcs):
        raise ValueError("polyeval takes terms whose rows are contiguous "
                         "(unit column stride)")
    if len({x.shape[1] for x in srcs}) != 1:
        raise ShapeContractError(
            f"polyeval's term tensors differ in width: {shapes}", shapes=shapes)
    if rows is not None:
        if len(srcs) != 1:
            raise ValueError("polyeval takes rows= with one term tensor only")
        if (not isinstance(rows, torch.Tensor) or rows.dtype != torch.int64
                or rows.ndim != 1 or not rows.is_contiguous()):
            raise TypeError("polyeval takes rows= as a contiguous int64 "
                            "vector")
        k = rows.shape[0]
    else:
        k = sum(x.shape[0] for x in srcs)
    if vand.shape[1] != k:
        raise ShapeContractError(
            f"polyeval needs vand [N,K] against K term rows: got {shapes}"
            + ("" if rows is None else f" and {k} row indices"), shapes=shapes)
    devices = {x.device for x in (vand,) + srcs
               + (() if rows is None else (rows,))}
    if len(devices) != 1:
        raise ValueError(f"polyeval operands on {sorted(map(str, devices))}")
    return k


def polyeval(vand: torch.Tensor, terms: Terms, *, p: int,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vand: [N, K]`` contiguous int64 against the K rows of ``terms``
    (a tensor ``[K, C]``; a tensor ``[R, C]`` with ``rows``, a device int64
    index of length K; or a pair ``([K1, C], [K2, C])``, stacked), field
    elements (< p) on one device; returns ``[N, C]`` int64.  Any N and K,
    either prime.  On the card an index outside ``[0, R)`` traps the
    kernel, as ``index_select`` asserts."""
    srcs = _sources(terms)
    k = _check(vand, srcs, rows)
    if vand.device.type == "cpu":
        return polyeval_plain(vand, terms, p=p, rows=rows)
    if vand.device.type != "cuda":
        raise ValueError(f"polyeval runs on cpu or cuda, not {vand.device}")
    n, c = vand.shape[0], srcs[0].shape[1]
    args = _build.fold_args(p)
    out = torch.empty((n, c), dtype=torch.int64, device=vand.device)
    src_args = []
    for i in range(2):
        if i < len(srcs):
            x = srcs[i]
            count = k if rows is not None else x.shape[0]
            src_args += [x.data_ptr(), None if rows is None else rows.data_ptr(),
                         x.stride(0), x.shape[0], count]
        else:
            src_args += [None, None, 0, 0, 0]
    with torch.cuda.device(vand.device):
        stream = torch.cuda.current_stream(vand.device).cuda_stream
        err = _lib()(vand.data_ptr(), *src_args, out.data_ptr(), n, k, c,
                     *args, stream)
    _build.check(err, "polyeval")
    polyeval.launches += 1
    return out


polyeval.launches = 0

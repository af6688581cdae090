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

Each form also comes batched over B lanes, one launch for the whole
batch, ``[B, N, C]`` out (the batched engine's waves):

* ``[B, K, C]``, or a pair ``([B, K1, C], [B, K2, C])``: lane b reads
  its own rows;
* ``[B, R, C]`` with a 1-D ``rows``: lane b reads ``terms[b, rows]``;
* ``[R, C]`` with a 2-D ``rows`` ``[B, K]``: lane b reads
  ``terms[rows[b]]`` (decode of a survivor pattern's lanes out of a wave).

Rows need unit column stride; row and lane strides are read as they are.

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
from . import _build, work
from .barrett import matmul_plain

Terms = Union[torch.Tensor, Sequence[torch.Tensor]]


def _sources(terms: Terms) -> Tuple[torch.Tensor, ...]:
    return (terms,) if isinstance(terms, torch.Tensor) else tuple(terms)


def stacked_terms(terms: Terms, rows: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``T`` (``[K, C]``, or ``[B, K, C]`` batched) as the kernel reads it:
    the indexed rows for an index, the sources stacked for a pair, the
    tensor itself otherwise."""
    srcs = _sources(terms)
    x = srcs[0]
    if rows is not None:
        if rows.ndim == 2:                    # per-lane rows of one [R, C]
            return x[rows]
        return x.index_select(x.ndim - 2, rows)
    return x if len(srcs) == 1 else torch.cat(srcs, dim=-2)


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
              ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_longlong]
    fn.argtypes = ([ctypes.c_void_p] + source + source
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(vand, srcs, rows) -> Tuple[int, Optional[int]]:
    """Validates the operands; returns ``(K, B)``, ``B`` None unbatched."""
    for x in (vand,) + srcs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f"polyeval takes int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
    if not 1 <= len(srcs) <= 2:
        raise ShapeContractError(
            f"polyeval takes one or two term tensors, got {len(srcs)}",
            shapes=tuple(x.shape for x in srcs))
    shapes = (vand.shape,) + tuple(x.shape for x in srcs)
    ndim = srcs[0].ndim
    if (vand.ndim != 2 or ndim not in (2, 3)
            or any(x.ndim != ndim for x in srcs)
            or (ndim == 3 and len({x.shape[0] for x in srcs}) != 1)):
        raise ShapeContractError(
            f"polyeval needs vand [N,K] and terms [K_i,C] (or [B,K_i,C] "
            f"for every source): got {shapes}", shapes=shapes)
    if not vand.is_contiguous():
        raise ValueError("polyeval takes a contiguous vand")
    if any(x.stride(-1) != 1 and x.numel() > 0 for x in srcs):
        raise ValueError("polyeval takes terms whose rows are contiguous "
                         "(unit column stride)")
    if len({x.shape[-1] for x in srcs}) != 1:
        raise ShapeContractError(
            f"polyeval's term tensors differ in width: {shapes}", shapes=shapes)
    lanes = srcs[0].shape[0] if ndim == 3 else None
    if rows is not None:
        if len(srcs) != 1:
            raise ValueError("polyeval takes rows= with one term tensor only")
        if (not isinstance(rows, torch.Tensor) or rows.dtype != torch.int64
                or rows.ndim not in (1, 2) or not rows.is_contiguous()):
            raise TypeError("polyeval takes rows= as a contiguous int64 "
                            "vector, or a [B, K] matrix")
        if rows.ndim == 2:
            if ndim != 2:
                raise ShapeContractError(
                    "polyeval takes per-lane rows [B, K] into one [R, C] "
                    f"tensor: got terms {tuple(srcs[0].shape)}",
                    shapes=shapes)
            lanes = rows.shape[0]
        k = rows.shape[-1]
    else:
        k = sum(x.shape[-2] for x in srcs)
    if vand.shape[1] != k:
        raise ShapeContractError(
            f"polyeval needs vand [N,K] against K term rows: got {shapes}"
            + ("" if rows is None else f" and {k} row indices"), shapes=shapes)
    devices = {x.device for x in (vand,) + srcs
               + (() if rows is None else (rows,))}
    if len(devices) != 1:
        raise ValueError(f"polyeval operands on {sorted(map(str, devices))}")
    return k, lanes


def polyeval(vand: torch.Tensor, terms: Terms, *, p: int,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vand: [N, K]`` contiguous int64 against the K rows of ``terms``
    (a tensor ``[K, C]``; a tensor ``[R, C]`` with ``rows``, a device int64
    index of length K; or a pair ``([K1, C], [K2, C])``, stacked), field
    elements (< p) on one device; returns ``[N, C]`` int64.  The batched
    forms (module docstring) return ``[B, N, C]`` from one launch.  Any N
    and K, either prime.  On the card an index outside ``[0, R)`` traps
    the kernel, as ``index_select`` asserts."""
    srcs = _sources(terms)
    k, lanes = _check(vand, srcs, rows)
    if vand.device.type == "meta":
        n, c = vand.shape[0], srcs[0].shape[-1]
        nbytes, ops = work.pe_work(n, k, c, p)
        b = 1 if lanes is None else lanes
        work.record("polyeval", b * nbytes, b * ops)
        return vand.new_empty((n, c) if lanes is None else (b, n, c))
    if vand.device.type == "cpu":
        return polyeval_plain(vand, terms, p=p, rows=rows)
    if vand.device.type != "cuda":
        raise ValueError(f"polyeval runs on cpu or cuda, not {vand.device}")
    n, c = vand.shape[0], srcs[0].shape[-1]
    b = 1 if lanes is None else lanes
    args = _build.fold_args(p)
    out = torch.empty((n, c) if lanes is None else (b, n, c),
                      dtype=torch.int64, device=vand.device)
    src_args = []
    for i in range(2):
        if i < len(srcs):
            x = srcs[i]
            count = k if rows is not None else x.shape[-2]
            # a source is (base, index, row stride, rows, K rows, lane
            # stride, index lane stride)
            src_args += [x.data_ptr(), None if rows is None else rows.data_ptr(),
                         x.stride(-2), x.shape[-2], count,
                         x.stride(0) if x.ndim == 3 else 0,
                         k if rows is not None and rows.ndim == 2 else 0]
        else:
            src_args += [None, None, 0, 0, 0, 0, 0]
    with torch.cuda.device(vand.device):
        stream = torch.cuda.current_stream(vand.device).cuda_stream
        err = _lib()(vand.data_ptr(), *src_args, out.data_ptr(), n, k, c, b,
                     *args, stream)
    _build.check(err, "polyeval")
    _build.count(polyeval)
    return out


polyeval.launches = 0

"""One hop's fold of the phase-2 ring reduce-scatter on the card.

``ring_fold(acc, chunk, p=p)`` returns ``(acc + chunk) mod p`` elementwise
as a new tensor, for int32 or int64 field elements (< p, p < 2^31) of one
shape on one device.  The int32 wire of the sharded runner
(:func:`repro_torch.mpc.secure_matmul.mod_ring_reduce_scatter`) launches it
at every shard of every hop; for Mersenne-31 the sum reaches
``2^32 - 4``, so the kernel adds in the unsigned type of the payload's
width and subtracts p once.

A port-only kernel: the JAX package folds inside the ``fori_loop`` of
``mod_ring_reduce_scatter`` (``repro/mpc/secure_matmul.py:43``) in plain
JAX, with no Pallas kernel.  ``csrc/ring_fold.cu`` streams the three
tensors once with 16-byte accesses; the source states its bound.

The output is always fresh (``torch.empty``): on a mesh that repeats a
device a ring hop moves nothing (``t.to(same_device)`` is ``t``), so an
in-place fold could write into a chunk another shard still reads.  The
wrapper checks its operands, launches on the device's current stream and
counts the launch in ``ring_fold.launches``.  A CPU tensor takes the plain
version (:func:`ring_fold_plain`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..mpc.errors import ShapeContractError
from . import _build, work

DTYPES = (torch.int32, torch.int64)


def ring_fold_plain(acc: torch.Tensor, chunk: torch.Tensor, *,
                    p: int) -> torch.Tensor:
    """The plain version, as JAX writes the fold: the sum in int64, then
    ``% p``, cast back to the payload's type."""
    return torch.remainder(acc.to(torch.int64) + chunk.to(torch.int64),
                           p).to(acc.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("ring_fold").ring_fold_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ring_fold(acc: torch.Tensor, chunk: torch.Tensor, *, p: int) -> torch.Tensor:
    """``(acc + chunk) mod p`` as a new tensor; ``acc`` and ``chunk`` are
    int32 or int64 field elements in ``[0, p)`` of one shape, type and
    device, with ``p < 2^31``."""
    for x in (acc, chunk):
        if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
            raise TypeError(f"ring_fold takes int32 or int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
    if acc.dtype != chunk.dtype or acc.shape != chunk.shape:
        raise ShapeContractError(
            f"ring_fold needs two tensors of one shape and type: "
            f"{tuple(acc.shape)} {acc.dtype} and {tuple(chunk.shape)} "
            f"{chunk.dtype}", shapes=(acc.shape, chunk.shape))
    if acc.device != chunk.device:
        raise ValueError(f"ring_fold operands on {acc.device} and "
                         f"{chunk.device}")
    if not 2 <= p < 2**31:
        raise ValueError(f"ring_fold takes primes below 2^31, got p={p}")
    if acc.device.type == "meta":
        work.record("ring_fold", *work.fold_work(acc.numel(),
                                                 acc.element_size()))
        return torch.empty_like(acc)
    if acc.device.type == "cpu":
        return ring_fold_plain(acc, chunk, p=p)
    if acc.device.type != "cuda":
        raise ValueError(f"ring_fold runs on cpu or cuda, not {acc.device}")
    if not (acc.is_contiguous() and chunk.is_contiguous()):
        raise ValueError("ring_fold takes contiguous tensors")
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = _lib()(acc.data_ptr(), chunk.data_ptr(), out.data_ptr(),
                     acc.numel(), acc.element_size(), p, stream)
    _build.check(err, "ring_fold")
    _build.count(ring_fold)
    return out


ring_fold.launches = 0

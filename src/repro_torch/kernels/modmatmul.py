"""Modular matrix products on the card: the phase-2 worker hot loop.

``O = (A @ B) mod p`` for field elements (int64 storage, values < p).

Port of ``repro/kernels/modmatmul.py``.  The CUDA kernel
(``csrc/modmatmul.cu``) replaces both Pallas kernels: one block per
(worker, 64×64 output tile) loops over K with shared-memory tiles and a
register micro-tile, folding with ``mod_p`` every ``acc_window(p)``
products.  When the output tiles cannot fill the card, K is split across
blocks as well (:func:`k_splits`).  The source states its bound and
design.

Two wrappers, one kernel:

* :func:`modmatmul_batched` — all W workers' ``[M,K] @ [K,N]`` in one
  launch (``worker_compute``'s product);
* :func:`modmatmul` — one product, the kernel's ``W = 1`` launch.

Each wrapper checks its operands, allocates the output with
``torch.empty``, launches on the current stream and counts the launch in
its ``launches`` attribute.  A CPU tensor takes the plain version
(:func:`modmatmul_plain`, the :mod:`repro_torch.kernels.barrett` ops); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..mpc.errors import ShapeContractError
from ..mpc.field import acc_window
from . import _build
from .barrett import matmul_plain


def modmatmul_plain(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """The plain version: exact ``(a @ b) mod p`` from the barrett ops,
    batched over leading dims, on any device."""
    return matmul_plain(a, b, p=p, window=acc_window(p))


TILE = 64          # output tile side of one block (BM = BN in modmatmul.cu)
TILE_K = 32        # K depth staged per shared-memory pass (BK)
MIN_SPLIT_K = 512  # fewest K rows worth a block of their own
MAX_GRID_Z = 65535


def k_splits(w: int, m: int, k: int, n: int, sms: int):
    """``(splits, k_chunk)``: how many blocks share each output tile's K.

    One block per output tile (``splits = 1``) as long as the tiles give
    every SM two blocks.  Below that (a skinny product such as the MAC
    tags' ``[N, (m/t)²] @ [(m/t)², 1]``) K is cut into chunks of at least
    :data:`MIN_SPLIT_K` rows, a multiple of :data:`TILE_K`, so the grid
    reaches about two blocks per SM.
    """
    tiles = w * -(-m // TILE) * -(-n // TILE)
    want = min(-(-2 * sms // tiles), k // MIN_SPLIT_K, MAX_GRID_Z // max(w, 1))
    if want <= 1:
        return 1, max(k, 1)
    chunk = -(-k // want)
    chunk = -(-chunk // TILE_K) * TILE_K
    return -(-k // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("modmatmul")
    fn = lib.modmatmul_batched_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, ndim: int, what: str) -> None:
    for x in (a, b):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f"{what} takes int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
        if x.ndim != ndim:
            raise ShapeContractError(
                f"{what} takes {ndim}-D operands: {tuple(a.shape)} @ "
                f"{tuple(b.shape)}", shapes=(a.shape, b.shape))
        if not x.is_contiguous():
            raise ValueError(f"{what} takes contiguous operands")
    if a.device != b.device:
        raise ValueError(f"{what} operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {a.device}")
    lead_ok = ndim == 2 or a.shape[0] == b.shape[0]
    if a.shape[-1] != b.shape[-2] or not lead_ok:
        raise ShapeContractError(
            f"{what} operands disagree: {tuple(a.shape)} @ {tuple(b.shape)}",
            shapes=(a.shape, b.shape))


def _launch(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    w, m, k = a.shape
    n = b.shape[2]
    args = _build.fold_args(p)
    splits, chunk = k_splits(w, m, k, n, _sm_count(a.device.index))
    out = torch.empty((w, m, n), dtype=torch.int64, device=a.device)
    # per-split partials, each < p; summed mod p by the kernel's second pass
    part = (torch.empty((splits, w, m, n), dtype=torch.int64, device=a.device)
            if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     None if part is None else part.data_ptr(),
                     w, m, k, n, splits, chunk, *args, stream)
    _build.check(err, "modmatmul")
    return out


def modmatmul_batched(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """``(a[w] @ b[w]) mod p`` for every worker ``w`` in one launch.

    ``a: [W, M, K]``, ``b: [W, K, N]`` contiguous int64 field elements
    (< p) on one device.  Returns ``[W, M, N]`` int64.
    """
    _check(a, b, 3, "modmatmul_batched")
    if a.device.type == "cpu":
        return modmatmul_plain(a, b, p=p)
    out = _launch(a, b, p=p)
    modmatmul_batched.launches += 1
    return out


def modmatmul(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """``(a @ b) mod p`` for one ``[M, K] @ [K, N]`` product: the
    kernel's ``W = 1`` launch.  Same operand contract as
    :func:`modmatmul_batched`."""
    _check(a, b, 2, "modmatmul")
    if a.device.type == "cpu":
        return modmatmul_plain(a, b, p=p)
    out = _launch(a[None], b[None], p=p)[0]
    modmatmul.launches += 1
    return out


modmatmul_batched.launches = 0
modmatmul.launches = 0

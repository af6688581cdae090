"""Mamba's selective scan on the card, returning the final state.

``selective_scan(u, dt, a, b_t, c_t, *, return_state=False)`` takes u, dt
``[B, T, Di]`` and b_t, c_t ``[B, T, N]`` in one dtype (fp32 or bf16) and
a ``[Di, N]`` (fp32), and returns y ``[B, T, Di]`` fp32 and, with
``return_state``, the final state ``[B, Di, N]`` fp32:

    h_t = exp(dt_t · a) · h_{t-1} + (dt_t · u_t) · b_t,   h_0 = 0
    y_t = Σ_n h_t · c_t

which is ``_selective_scan_chunked`` of the JAX package
(``repro/models/ssm.py:59``).  Each operand is cast to fp32 before it is
multiplied.

A port-only kernel: the JAX package computes the scan in plain JAX (a
``lax.scan`` over chunks with a ``lax.associative_scan`` inside each), not
in a Pallas kernel.  The CUDA kernels (``csrc/selective_scan.cu``) keep h in
registers for all of T; two instances, of which :func:`choose_instance`
picks one before any launch:

* ``tma``: 4 states a thread, tiles of u, dt, b and c brought by TMA
  through a three-stage ring, the exponential as ``ex2.approx``; for
  operands whose bases are 16-byte aligned and whose batch and step
  strides are multiples of 16 bytes (the served layout);
* ``simple``: one thread per (batch, channel, state), tiles staged by
  plain loads, y summed over the state lanes with shuffles, for the rest.

The source states the bound and design.  N is 8, 16 or 32 on the card.

The wrapper checks its operands, allocates the outputs with
``torch.empty``, launches on the current stream and counts the launch in
``selective_scan.launches`` and ``selective_scan.instances[name]``;
``_launch(..., instance=...)`` runs one the chooser would not pick.  A
CPU tensor takes the plain version (:func:`selective_scan_plain`, the
reference's chunked associative scan, which counts its calls in
``selective_scan_plain.calls``); a CUDA tensor launches the kernel or
raises.

The kernel has no backward yet: on a CUDA tensor under autograd (an
operand that requires grad) the wrapper raises ``NotImplementedError``
naming ROADMAP queue 1, item 15, where the backward kernel will come; on
the CPU autograd differentiates the plain version.

:func:`agreement` is :func:`~repro_torch.kernels.rwkv6.agreement`: the
kernel and the plain version run in fp32 from the same inputs and differ
only in the order of their products and sums, as the two WKV versions do,
so the same limits hold (1e-4 of each element's |ref| plus its row's rms,
1e-5 in relative Frobenius norm).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from ..mpc.errors import ShapeContractError
from . import _build
from .rwkv6 import agreement

__all__ = ["agreement", "choose_instance", "selective_scan",
           "selective_scan_plain", "STATES"]

CHUNK = 256                     # SSMConfig.chunk: the plain version's window
STATES = (8, 16, 32)            # the kernel's N instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instances, as its C launcher numbers them
_INSTANCE_IDS = {"tma": 1, "simple": 0}
INSTANCES = tuple(_INSTANCE_IDS)

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _combine(earlier, later):
    """The scan's associative operator on (decay, state) pairs: ``later``
    applied after ``earlier``."""
    a1, x1 = earlier
    a2, x2 = later
    return a1 * a2, x2 + a2 * x1


def _inclusive_scan(dc: torch.Tensor, ic: torch.Tensor):
    """Inclusive scan of :func:`_combine` along dim 1, in log2(C) doubling
    steps (``lax.associative_scan``'s operator; its tree differs, which
    changes only the rounding)."""
    c = dc.shape[1]
    off = 1
    while off < c:
        a, x = _combine((dc[:, :-off], ic[:, :-off]), (dc[:, off:], ic[:, off:]))
        dc = torch.cat([dc[:, :off], a], dim=1)
        ic = torch.cat([ic[:, :off], x], dim=1)
        off *= 2
    return dc, ic


def selective_scan_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b_t: torch.Tensor, c_t: torch.Tensor, *,
                         chunk: int = CHUNK, return_state: bool = False
                         ) -> Result:
    """The plain version: the reference's chunked associative scan in
    fp32, on any device.  A ragged last chunk is padded with dt = 0 (decay
    1, increment 0), so the state passes through it untouched."""
    selective_scan_plain.calls += 1
    bsz, t, di = u.shape
    n = a.shape[-1]
    chunk = max(1, min(chunk, t))
    pad = (-t) % chunk
    u, dt, b_t, c_t = (x.float() for x in (u, dt, b_t, c_t))
    if pad:
        u, dt, b_t, c_t = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                           for x in (u, dt, b_t, c_t))
    a = a.float()
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, t + pad, chunk):
        sl = slice(c0, c0 + chunk)
        uc, dtc, btc, cc = u[:, sl], dt[:, sl], b_t[:, sl], c_t[:, sl]
        dc = torch.exp(dtc[..., None] * a[None, None])           # [B,C,Di,N]
        ic = (dtc * uc)[..., None] * btc[:, :, None, :]
        ic = torch.cat([ic[:, :1] + dc[:, :1] * h[:, None], ic[:, 1:]], dim=1)
        _, acc = _inclusive_scan(dc, ic)
        ys.append(torch.einsum("bcdn,bcn->bcd", acc, cc))
        h = acc[:, -1]
    y = torch.cat(ys, dim=1)[:, :t] if ys else u.new_zeros((bsz, 0, di))
    return (y, h) if return_state else y


selective_scan_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("selective_scan")
    fn = lib.selective_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def choose_instance(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor) -> str:
    """The kernel that serves these operands on the card: ``"tma"`` when
    every operand's base address is 16-byte aligned and its batch and step
    strides are multiples of 16 bytes (TMA moves whole 16-byte units), else
    ``"simple"``.  A pure function of dtype, strides and pointers, so the
    CPU tests can ask it."""
    for x in (u, dt, b_t, c_t):
        size = x.element_size()
        if x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:2]):
            return "simple"
    return "tma"


def _check(u, dt, a, b_t, c_t) -> None:
    ops = (u, dt, b_t, c_t)
    for x in ops:
        if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES:
            raise TypeError(f"selective_scan takes fp32 or bf16 u, dt, b_t, "
                            f"c_t, got {getattr(x, 'dtype', type(x))}")
    if len({x.dtype for x in ops}) != 1:
        raise TypeError(f"selective_scan operands disagree in dtype: "
                        f"{[x.dtype for x in ops]}")
    if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
        raise TypeError(f"selective_scan takes an fp32 a, got "
                        f"{getattr(a, 'dtype', type(a))}")
    if len({x.device for x in ops + (a,)}) != 1:
        raise ValueError(f"selective_scan operands on "
                         f"{[x.device for x in ops + (a,)]}")
    shapes = tuple(x.shape for x in (u, dt, a, b_t, c_t))
    if any(x.ndim != 3 for x in ops) or a.ndim != 2:
        raise ShapeContractError(
            f"selective_scan takes u, dt [B, T, Di], a [Di, N] and b_t, c_t "
            f"[B, T, N], got {shapes}", shapes=shapes)
    b, t, di = u.shape
    n = a.shape[1]
    if (dt.shape != u.shape or tuple(a.shape) != (di, n)
            or tuple(b_t.shape) != (b, t, n) or c_t.shape != b_t.shape):
        raise ShapeContractError(
            f"selective_scan needs u, dt [B, T, Di], a [Di, N] and b_t, c_t "
            f"[B, T, N]: got {shapes}", shapes=shapes)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_t: torch.Tensor, c_t: torch.Tensor, *,
                   return_state: bool = False, chunk: int = CHUNK) -> Result:
    """The selective scan: y ``[B, T, Di]`` fp32 and, with
    ``return_state``, the final state ``[B, Di, N]`` fp32.

    u, dt ``[B, T, Di]`` and b_t, c_t ``[B, T, N]`` share one dtype (fp32 or
    bf16) and device with a ``[Di, N]`` (fp32).  On the card N must be 8,
    16 or 32 and the last dims must have unit stride; the batch and step
    strides are read as they are.  ``chunk`` is the plain version's window
    (the CPU path); the kernel has none.
    """
    _check(u, dt, a, b_t, c_t)
    if u.device.type == "cpu":
        return selective_scan_plain(u, dt, a, b_t, c_t, chunk=chunk,
                                    return_state=return_state)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not {u.device}")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (u, dt, a, b_t, c_t)):
        raise NotImplementedError(
            "the selective_scan kernel has no backward yet (ROADMAP queue 1, "
            "item 15): hybrid (jamba) training runs on the CPU")
    n = a.shape[1]
    if n not in STATES:
        raise ShapeContractError(
            f"the selective_scan kernel takes N in {STATES}, got {n}",
            shapes=(a.shape,))
    if any(x.stride(2) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("selective_scan needs unit stride along the last dim")
    instance = choose_instance(u, dt, b_t, c_t)
    out = _launch(u, dt, a, b_t, c_t, instance=instance,
                  return_state=return_state)
    _build.count(selective_scan, instance)
    return out


def _launch(u, dt, a, b_t, c_t, *, instance: str,
            return_state: bool = False) -> Result:
    """Launch one instance on checked CUDA operands, uncounted: the
    wrapper's path after :func:`choose_instance`, and the way to time or
    check an instance the chooser would not pick."""
    if instance not in INSTANCES:
        raise ValueError(f"unknown selective_scan instance {instance!r}; "
                         f"known: {INSTANCES}")
    b, t, di = u.shape
    n = a.shape[1]
    ac = a.contiguous()
    y = torch.empty((b, t, di), dtype=torch.float32, device=u.device)
    state = (torch.empty((b, di, n), dtype=torch.float32, device=u.device)
             if return_state else None)
    strides = [st for x in (u, dt, b_t, c_t) for st in x.stride()[:2]]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _lib()(u.data_ptr(), dt.data_ptr(), ac.data_ptr(),
                     b_t.data_ptr(), c_t.data_ptr(), y.data_ptr(),
                     None if state is None else state.data_ptr(),
                     _INSTANCE_IDS[instance], _DTYPES[u.dtype], b, t, di, n,
                     *strides, stream)
    _build.check(err, f"selective_scan ({instance})")
    return (y, state) if return_state else y


selective_scan.launches = 0
selective_scan.instances = dict.fromkeys(INSTANCES, 0)

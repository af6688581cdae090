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

Training.  When autograd records (grad enabled and an operand that
requires grad), :func:`selective_scan` runs through :class:`SelectiveScan`
on either device.  On the card its forward launch (the chosen instance,
counted as above) also writes h at the start of every ``CHECKPOINT``
steps, ``[B, ceil(T / 32), Di, N]`` fp32, and its backward is
:func:`selective_scan_bwd`, the hand-written kernels of
``csrc/selective_scan_bwd.cu`` (launches in ``selective_scan_bwd
.launches`` and ``.instances``), which re-run each 32-step stretch
forward from its checkpoint and scan it in reverse; they replace the XLA
autodiff of the reference's scan.  :func:`choose_bwd_instance` picks
``tma`` (bf16 operands a TMA map takes: the training path; operands by a
TMA ring, e_t kept from the re-run) or ``sweep`` (the rest).  On the CPU
the backward is :func:`selective_scan_bwd_plain` (calls in
``selective_scan_bwd_plain.calls``), a reverse scan in plain torch.  The
serve path writes no checkpoint.

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
from . import _build, work
from .rwkv6 import agreement

__all__ = ["agreement", "choose_bwd_instance", "choose_instance",
           "grad_agreement", "selective_scan",
           "selective_scan_bwd", "selective_scan_bwd_plain",
           "selective_scan_plain", "SelectiveScan", "STATES"]

CHUNK = 256                     # SSMConfig.chunk: the plain version's window
STATES = (8, 16, 32)            # the kernel's N instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instances, as its C launcher numbers them
_INSTANCE_IDS = {"tma": 1, "simple": 0}
INSTANCES = tuple(_INSTANCE_IDS)
CHECKPOINT = 32                 # steps between the forward's checkpoints
GRAD_NAMES = ("du", "ddt", "da", "db", "dc")

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
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
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
    if u.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"selective_scan runs on cpu or cuda, not {u.device}")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (u, dt, a, b_t, c_t)):
        y, state = SelectiveScan.apply(u, dt, a, b_t, c_t, chunk)
        return (y, state) if return_state else y
    if u.device.type == "cpu":
        return selective_scan_plain(u, dt, a, b_t, c_t, chunk=chunk,
                                    return_state=return_state)
    y, state, _ = _forward(u, dt, a, b_t, c_t, return_state=return_state)
    return (y, state) if return_state else y


def _check_kernel(u, dt, a, b_t, c_t) -> None:
    """What the CUDA kernels (forward and backward) take beyond
    :func:`_check`: N in ``STATES`` and unit stride along the last dim."""
    n = a.shape[1]
    if n not in STATES:
        raise ShapeContractError(
            f"the selective_scan kernel takes N in {STATES}, got {n}",
            shapes=(a.shape,))
    if any(x.stride(2) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("selective_scan needs unit stride along the last dim")


def _forward(u, dt, a, b_t, c_t, *, return_state: bool,
             checkpoints: bool = False):
    """``(y, state or None, checkpoints or None)``: the chosen kernel on
    CUDA operands, counted; on ``meta``, empty outputs whose work goes to
    the tally (:mod:`.work`)."""
    if u.device.type == "meta":
        b, t, di = u.shape
        n = a.shape[1]
        work.record("selective_scan",
                    *work.scan_work(b, t, di, n, u.element_size()))
        f32 = {"dtype": torch.float32}
        return (u.new_empty((b, t, di), **f32),
                u.new_empty((b, di, n), **f32) if return_state else None,
                u.new_empty((b, -(-t // CHECKPOINT), di, n), **f32)
                if checkpoints else None)
    _check_kernel(u, dt, a, b_t, c_t)
    instance = choose_instance(u, dt, b_t, c_t)
    out = _launch(u, dt, a, b_t, c_t, instance=instance,
                  return_state=return_state, checkpoints=checkpoints)
    _build.count(selective_scan, instance)
    out = out if isinstance(out, tuple) else (out,)
    return (out[0], out[1] if return_state else None,
            out[-1] if checkpoints else None)


def _launch(u, dt, a, b_t, c_t, *, instance: str, return_state: bool = False,
            checkpoints: bool = False):
    """Launch one instance on checked CUDA operands, uncounted: the
    wrapper's path after :func:`choose_instance`, and the way to time or
    check an instance the chooser would not pick.  With ``checkpoints``
    it also writes h at the start of every ``CHECKPOINT`` steps and returns
    them last: ``(y[, state], hck)``."""
    if instance not in INSTANCES:
        raise ValueError(f"unknown selective_scan instance {instance!r}; "
                         f"known: {INSTANCES}")
    b, t, di = u.shape
    n = a.shape[1]
    ac = a.contiguous()
    y = torch.empty((b, t, di), dtype=torch.float32, device=u.device)
    state = (torch.empty((b, di, n), dtype=torch.float32, device=u.device)
             if return_state else None)
    hck = (torch.empty((b, -(-t // CHECKPOINT), di, n), dtype=torch.float32,
                       device=u.device) if checkpoints else None)
    strides = [st for x in (u, dt, b_t, c_t) for st in x.stride()[:2]]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _lib()(u.data_ptr(), dt.data_ptr(), ac.data_ptr(),
                     b_t.data_ptr(), c_t.data_ptr(), y.data_ptr(),
                     None if state is None else state.data_ptr(),
                     None if hck is None else hck.data_ptr(),
                     _INSTANCE_IDS[instance], _DTYPES[u.dtype], b, t, di, n,
                     *strides, stream)
    _build.check(err, f"selective_scan ({instance})")
    out = (y, state) if return_state else (y,)
    if checkpoints:
        return out + (hck,)
    return out if return_state else y


selective_scan.launches = 0
selective_scan.instances = dict.fromkeys(INSTANCES, 0)


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its hand-written backward.  On the card the
    forward keeps h every ``CHECKPOINT`` steps (the states the backward
    re-runs from); on the CPU it keeps nothing, and the plain backward
    recomputes the states.  Returns ``(y, state)``.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass,
    and is counted again."""

    @staticmethod
    def forward(ctx, u, dt, a, b_t, c_t, chunk):
        if u.device.type == "cpu":
            y, state = selective_scan_plain(u, dt, a, b_t, c_t, chunk=chunk,
                                            return_state=True)
            hck = None
        else:
            y, state, hck = _forward(u, dt, a, b_t, c_t, return_state=True,
                                     checkpoints=True)
        ctx.save_for_backward(u, dt, a, b_t, c_t, hck)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        u, dt, a, b_t, c_t, hck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        grads = selective_scan_bwd(u, dt, a, b_t, c_t, dy, dstate=dstate,
                                   checkpoints=hck, chunk=ctx.chunk)
        return grads + (None,)


def grad_agreement(got, ref) -> dict:
    """How far the backward's ``got = (du, ddt, da, db, dc)`` lies from
    ``ref`` (autograd of :func:`selective_scan_plain` on the same operands),
    per gradient and over all, in the form and limits of
    :func:`~repro_torch.kernels.flash_attention.grad_agreement`."""
    from .flash_attention import grad_agreement as _grad_agreement

    return _grad_agreement(got, ref, names=GRAD_NAMES)


def _states(u, dt, a, b_t, c_t, chunk):
    """Every state ``h_t [B, T, Di, N]`` (fp32) and every decay ``e_t``,
    by the plain version's chunked scan."""
    bsz, t, di = u.shape
    n = a.shape[-1]
    e = torch.exp(dt[..., None] * a)                          # [B,T,Di,N]
    inc = (dt * u)[..., None] * b_t[:, :, None, :]
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
    hs = []
    for c0 in range(0, t, chunk):
        dc, ic = e[:, c0:c0 + chunk], inc[:, c0:c0 + chunk]
        ic = torch.cat([ic[:, :1] + dc[:, :1] * h[:, None], ic[:, 1:]], dim=1)
        _, acc = _inclusive_scan(dc, ic)
        hs.append(acc)
        h = acc[:, -1]
    return torch.cat(hs, dim=1), e


def _next_decay(e):
    """``e_{t+1}`` at every t (1 past the last step): the decay that G's
    chain takes from step t + 1 back to t."""
    return torch.cat([e[:, 1:], torch.ones_like(e[:, :1])], dim=1)


def selective_scan_bwd_plain(u, dt, a, b_t, c_t, dy, *, dstate=None,
                             chunk: int = CHUNK):
    """The plain version of :func:`selective_scan_bwd` on any device, in
    fp32: the states by the forward's chunked scan, then ``G_t`` by the
    same scan run backward in time (``G_t = c_t dy_t + e_{t+1} G_{t+1}``),
    then the gradients as sums of products."""
    selective_scan_bwd_plain.calls += 1
    dtype = u.dtype
    uf, dtf, bf, cf = (x.float() for x in (u, dt, b_t, c_t))
    af, dy = a.float(), dy.float()
    bsz, t, di = u.shape
    n = a.shape[-1]
    if t == 0:
        return (torch.zeros_like(u), torch.zeros_like(dt), torch.zeros_like(af),
                torch.zeros_like(b_t), torch.zeros_like(c_t))
    hs, e = _states(uf, dtf, af, bf, cf, max(1, min(chunk, t)))
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    g_in = cf[:, :, None, :] * dy[..., None]                 # c_t dy_t
    if dstate is not None:
        g_in[:, -1] += dstate.float()
    _, g = _inclusive_scan(_next_decay(e).flip(1), g_in.flip(1))
    g = g.flip(1)                                             # G_t
    eh = e * h_prev
    du = dtf * torch.einsum("btdn,btn->btd", g, bf)
    ddt = (torch.einsum("btdn,btd,btn->btd", g, uf, bf)
           + torch.einsum("btdn,dn,btdn->btd", g, af, eh))
    da = torch.einsum("btdn,btd,btdn->dn", g, dtf, eh)
    db = torch.einsum("btdn,btd->btn", g, dtf * uf)
    dc = torch.einsum("btdn,btd->btn", hs, dy)
    return (du.to(dtype), ddt.to(dtype), da.to(a.dtype), db.to(dtype),
            dc.to(dtype))


selective_scan_bwd_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("selective_scan_bwd")
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# the backward's instances, as its C launcher numbers them
_BWD_INSTANCE_IDS = {"tma": 1, "sweep": 0}
BWD_INSTANCES = tuple(_BWD_INSTANCE_IDS)


def choose_bwd_instance(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor,
                        c_t: torch.Tensor) -> str:
    """The backward kernel that serves these operands on the card:
    ``"tma"`` (a TMA ring in, e_t kept from the re-run) for bf16 operands
    where :func:`choose_instance` would take the forward's ``tma`` instance
    and the fp32 ``dy`` rows (Di elements) are whole 16-byte units (the
    training path), else ``"sweep"``: fp32 operands double the ring, so
    the ``tma`` instance fits one block an SM and ran slower than
    ``sweep`` there on an H100 (``PERF.md``).  A pure function of dtype,
    shapes, strides and pointers, so the CPU tests can ask it."""
    if (u.dtype != torch.bfloat16 or u.shape[-1] % 4
            or choose_instance(u, dt, b_t, c_t) != "tma"):
        return "sweep"
    return "tma"


def selective_scan_bwd(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b_t: torch.Tensor, c_t: torch.Tensor, dy: torch.Tensor,
                       *, dstate=None, checkpoints=None, chunk: int = CHUNK):
    """``(du, ddt, da, db, dc)`` of ``(y, state) = selective_scan(u, dt, a,
    b_t, c_t, return_state=True)`` given ``dy [B, T, Di]``, the gradient of
    y, and ``dstate [B, Di, N]`` (or None for 0), that of the final state;
    each in its operand's shape and dtype.

    On the card (N in ``STATES``) ``checkpoints`` must be the forward
    launch's ``[B, ceil(T / 32), Di, N]`` states; :func:`choose_bwd_instance`
    picks ``tma`` or ``sweep`` (``csrc/selective_scan_bwd.cu``), one launch
    counted in ``selective_scan_bwd.launches`` and ``.instances``.  A CPU
    tensor takes :func:`selective_scan_bwd_plain` (``chunk`` is its
    forward's window).  Nothing falls back.
    """
    _check(u, dt, a, b_t, c_t)
    bsz, t, di = u.shape
    n = a.shape[1]
    if tuple(dy.shape) != (bsz, t, di) or dy.device != u.device:
        raise ShapeContractError(
            f"selective_scan_bwd needs dy {(bsz, t, di)} on {u.device}, got "
            f"{tuple(dy.shape)} on {dy.device}", shapes=(dy.shape,))
    if dstate is not None and tuple(dstate.shape) != (bsz, di, n):
        raise ShapeContractError(
            f"selective_scan_bwd needs dstate {(bsz, di, n)}, got "
            f"{tuple(dstate.shape)}", shapes=(dstate.shape,))
    if u.device.type == "meta":
        work.record("selective_scan_bwd",
                    *work.scan_bwd_work(bsz, t, di, n, u.element_size()))
        return tuple(x.new_empty(x.shape) for x in (u, dt, a, b_t, c_t))
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, dt, a, b_t, c_t, dy, dstate=dstate,
                                        chunk=chunk)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd runs on cpu or cuda, not "
                         f"{u.device}")
    instance = choose_bwd_instance(u, dt, b_t, c_t)
    grads = _bwd_launch(u, dt, a, b_t, c_t, dy, dstate=dstate,
                        checkpoints=checkpoints, instance=instance)
    _build.count(selective_scan_bwd, instance)
    return grads


def _bwd_launch(u, dt, a, b_t, c_t, dy, *, dstate=None, checkpoints=None,
                instance: str):
    """Launch one backward instance on checked CUDA operands, uncounted:
    the wrapper's path after :func:`choose_bwd_instance`, and the way to
    time or check an instance the chooser would not pick."""
    if instance not in BWD_INSTANCES:
        raise ValueError(f"unknown selective_scan_bwd instance {instance!r}; "
                         f"known: {BWD_INSTANCES}")
    _check_kernel(u, dt, a, b_t, c_t)
    bsz, t, di = u.shape
    n = a.shape[1]
    want = (bsz, -(-t // CHECKPOINT), di, n)
    if (checkpoints is None or tuple(checkpoints.shape) != want
            or checkpoints.dtype != torch.float32
            or not checkpoints.is_contiguous()):
        raise ShapeContractError(
            f"selective_scan_bwd needs the forward's fp32 checkpoints {want}",
            shapes=(None if checkpoints is None else checkpoints.shape,))
    dev, dtype = u.device, u.dtype
    # blocks of channels (the db and dc partials): 32 channels a block
    # (sweep) or 512 / N (tma)
    nblk = -(-di // (32 if instance == "sweep" else 512 // n))
    du, ddt = (torch.empty((bsz, t, di), dtype=dtype, device=dev)
               for _ in range(2))
    db, dc = (torch.empty((bsz, t, n), dtype=dtype, device=dev)
              for _ in range(2))
    da = torch.empty((di, n), dtype=torch.float32, device=dev)
    # scratch: da per batch row, db and dc per block of channels
    da_part = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    db_part, dc_part = (torch.empty((bsz, nblk, t, n), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    dyc = dy.float().contiguous()
    ds = None if dstate is None else dstate.float().contiguous()
    ac = a.contiguous()
    strides = [st for x in (u, dt, b_t, c_t) for st in x.stride()[:2]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_lib()(u.data_ptr(), dt.data_ptr(), ac.data_ptr(),
                         b_t.data_ptr(), c_t.data_ptr(), checkpoints.data_ptr(),
                         dyc.data_ptr(), None if ds is None else ds.data_ptr(),
                         du.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                         db.data_ptr(), dc.data_ptr(), da_part.data_ptr(),
                         db_part.data_ptr(), dc_part.data_ptr(),
                         _BWD_INSTANCE_IDS[instance], _DTYPES[dtype], bsz, t,
                         di, n, *strides, stream)
    _build.check(err, f"selective_scan_bwd ({instance})")
    return du, ddt, da, db, dc


selective_scan_bwd.launches = 0
selective_scan_bwd.instances = dict.fromkeys(BWD_INSTANCES, 0)

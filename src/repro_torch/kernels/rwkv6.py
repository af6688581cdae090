"""The RWKV-6 WKV recurrence on the card, returning the final state.

``rwkv6(r, k, v, w, u, state0=None)`` takes r, k, w ``[B, T, H, K]``,
v ``[B, T, H, V]``, u ``[H, K]`` and an optional fp32 ``state0
[B, H, K, V]``, and returns ``(out [B, T, H, V], state [B, H, K, V])``,
both fp32:

    out_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)
    S_t   = diag(exp(-exp(w_t))) · S_{t-1} + k_tᵀ v_t

which is ``ref.rwkv6_scan_with_state`` of the JAX package.  Inputs may be
bf16 or fp32; the arithmetic is fp32, apart from the bonus scalar
``a_t = Σ_k r_t u k_t`` (``diag(u)`` term: ``r_t · diag(u) k_tᵀ v_t =
a_t v_t``), which both versions sum in fp64 and round once.  At t = 0,
with a zero state, ``a_0 v_0`` is the whole output row, and ``a_0`` can
cancel: on a model's real operands one head's ``a_0`` came to 8e-4 from
terms of about 0.25, where an fp32 sum in any order is 1e-3 off
relatively, ten times the element limit of :func:`agreement`.

Port of ``repro/kernels/rwkv6.py``, which returns no state.  The CUDA
kernel (``csrc/rwkv6.cu``) gives each block one (batch, head, slice of V:
64 columns when B·H fills the card, down to 8 when it does not) and
keeps that slice of the state in registers for the whole sequence.  Two
producer warps bulk-copy tiles of steps into shared memory ahead of use
and turn them into fp32 r, k, v, the decay and the fp64 bonus scalar;
the consumer warps run only the recurrence.  The loop is bounded at T,
so no padded step decays the state; the source states its bound and
design.  K = V = 64 on the card.

The wrapper checks its operands, allocates the outputs with
``torch.empty``, launches on the current stream and counts the launch in
``rwkv6.launches``.  A CPU tensor takes the plain version
(:func:`rwkv6_plain`, which counts its calls in ``rwkv6_plain.calls``); a
CUDA tensor launches the kernel or raises.

The kernel has no backward yet: on a CUDA tensor under autograd (an
operand that requires grad) the wrapper raises ``NotImplementedError``
naming ROADMAP queue 1, item 15, where the backward kernel will come; on
the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..mpc.errors import ShapeContractError
from . import _build

HEAD_SIZE = 64                  # the kernel's K = V
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel against its plain version on the same operands (see
# :func:`agreement`).  Both run in fp32 from the same inputs and differ
# only in the order of their sums, so an element may differ by 1e-4 of
# |ref| plus its row's rms over V, and the whole by 1e-5 in relative
# Frobenius norm.
ELEMENT_TOL = 1e-4
FROBENIUS_TOL = 1e-5


def agreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``got`` lies from ``ref`` (an output ``[B, T, H, V]`` or a
    state ``[B, H, K, V]`` of the plain version on the same operands):
    ``max_abs_err``; ``worst``, the largest element error over its limit
    ``ELEMENT_TOL * (|ref| + rms of its row over V)``; ``rel_frob``,
    ``||got - ref|| / ||ref||``; ``worst_at``, the index of the worst
    element, and its row's rms; and ``ok``, whether both stay within their
    limits."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise ShapeContractError(f"agreement of {tuple(g.shape)} against "
                                 f"{tuple(r.shape)}", shapes=(g.shape, r.shape))
    if not r.numel():
        return {"max_abs_err": 0.0, "worst": 0.0, "rel_frob": 0.0,
                "worst_at": None, "ok": True}
    err = (g - r).abs()
    row_rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = ELEMENT_TOL * (r.abs() + row_rms)
    # an exact 0 passes a 0 limit (an all-zero row); NaN fails
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    flat = int(ratio.nan_to_num(float("inf")).argmax())
    at = tuple(int(i) for i in torch.unravel_index(torch.tensor(flat), r.shape))
    worst = float(ratio.max())
    rel_frob = float(err.norm() / r.norm().clamp_min(1e-30))
    return {"max_abs_err": float(err.max()), "worst": worst,
            "rel_frob": rel_frob,
            "worst_at": (at, float(row_rms[at[:-1]])),
            "ok": worst <= 1.0 and rel_frob <= FROBENIUS_TOL}


def rwkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the sequential recurrence in fp32 (the bonus
    scalar in fp64), one step at a time, on any device and for any head
    sizes."""
    rwkv6_plain.calls += 1
    r, k, v, w = (x.float() for x in (r, k, v, w))
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=k.device)
             if state0 is None else state0.float().clone())
    decay = torch.exp(-torch.exp(w))
    bonus = torch.einsum("bthk,hk,bthk->bth", r.double(), u.double(),
                         k.double()).float()[..., None]
    out = torch.empty((b, t, h, dv), dtype=torch.float32, device=k.device)
    for i in range(t):
        out[:, i] = (torch.einsum("bhk,bhkv->bhv", r[:, i], state)
                     + bonus[:, i] * v[:, i])
        state = (state * decay[:, i, :, :, None]
                 + k[:, i, :, :, None] * v[:, i, :, None, :])
    return out, state


rwkv6_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rwkv6")
    fn = lib.rwkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state0) -> None:
    ops = (r, k, v, w)
    for x in ops:
        if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES:
            raise TypeError(f"rwkv6 takes fp32 or bf16 r, k, v, w, got "
                            f"{getattr(x, 'dtype', type(x))}")
    if len({x.dtype for x in ops}) != 1:
        raise TypeError(f"rwkv6 operands disagree in dtype: "
                        f"{[x.dtype for x in ops]}")
    if len({x.device for x in ops + (u,)}) != 1:
        raise ValueError(f"rwkv6 operands on {[x.device for x in ops + (u,)]}")
    shapes = tuple(x.shape for x in ops + (u,))
    if any(x.ndim != 4 for x in ops) or u.ndim != 2:
        raise ShapeContractError(
            f"rwkv6 takes r, k, v, w [B, T, H, D] and u [H, K], got {shapes}",
            shapes=shapes)
    b, t, h, dk = k.shape
    if (r.shape != k.shape or w.shape != k.shape or v.shape[:3] != (b, t, h)
            or tuple(u.shape) != (h, dk)):
        raise ShapeContractError(
            f"rwkv6 needs r, k, w [B, T, H, K], v [B, T, H, V] and u [H, K]: "
            f"got {shapes}", shapes=shapes)
    if state0 is not None:
        want = (b, h, dk, v.shape[-1])
        if tuple(state0.shape) != want or state0.dtype != torch.float32:
            raise ShapeContractError(
                f"rwkv6 takes an fp32 state0 {want}, got {state0.dtype} "
                f"{tuple(state0.shape)}", shapes=(state0.shape,))
        if state0.device != k.device:
            raise ValueError(f"state0 on {state0.device}, operands on {k.device}")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *, state0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence: ``(out [B,T,H,V], state [B,H,K,V])``, fp32.

    r, k, w ``[B, T, H, K]`` and v ``[B, T, H, V]`` share one dtype (fp32
    or bf16) and device; u ``[H, K]`` broadcasts over B; ``state0`` is an
    fp32 ``[B, H, K, V]`` start state (zeros when None).  On the card
    K = V = 64 and the last dim must have unit stride; the other strides
    are read as they are.
    """
    _check(r, k, v, w, u, state0)
    if k.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, state0=state0)
    if k.device.type != "cuda":
        raise ValueError(f"rwkv6 runs on cpu or cuda, not {k.device}")
    ops = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in ops):
        raise NotImplementedError(
            "the rwkv6 kernel has no backward yet (ROADMAP queue 1, item 15): "
            "rwkv (ssm) training runs on the CPU")
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    if dk != HEAD_SIZE or dv != HEAD_SIZE:
        raise ShapeContractError(
            f"the rwkv6 kernel takes K = V = {HEAD_SIZE}, got K {dk}, V {dv}",
            shapes=(k.shape, v.shape))
    if any(x.stride(3) != 1 for x in (r, k, v, w)):
        raise ValueError("rwkv6 needs unit stride along the head dim")
    uf = u.float().contiguous()
    s0 = None if state0 is None else state0.contiguous()
    out = torch.empty((b, t, h, dv), dtype=torch.float32, device=k.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=k.device)
    strides = [st for x in (r, k, v, w) for st in x.stride()[:3]]
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     uf.data_ptr(), None if s0 is None else s0.data_ptr(),
                     out.data_ptr(), state.data_ptr(), _DTYPES[k.dtype], b, t,
                     h, dk, dv, *strides, stream)
    _build.check(err, "rwkv6")
    rwkv6.launches += 1
    return out, state


rwkv6.launches = 0

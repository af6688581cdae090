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

Training.  When autograd records (grad enabled and an operand that
requires grad), :func:`rwkv6` runs through :class:`WKV6` on either
device: the forward as above, and the backward :func:`rwkv6_bwd`, the
hand-written kernels of ``csrc/rwkv6_bwd.cu`` on the card (launches in
``rwkv6_bwd.launches`` and ``.instances``), which replace the XLA
autodiff of the reference's ``rwkv6_chunked``; on the CPU its plain
version :func:`rwkv6_bwd_plain` (calls in ``rwkv6_bwd_plain.calls``).
:func:`choose_bwd_instance` picks one of two instances by dtype:

* ``chunked`` (bf16, the training path): the chunked form on tensor cores.
  S at every ``CHUNK`` steps' start and G at their end by the chunk
  recurrences, then per chunk the same recurrences over ``SUB_CHUNK``
  steps, the gradients' state terms as TF32 ``wgmma`` products and the
  pairs inside a sub-chunk with exact gates on CUDA cores; its plain
  version is :func:`rwkv6_bwd_chunked_plain`;
* ``sweep`` (fp32, held to fp32's 1e-5): a forward sweep that recomputes S
  and gives dr, then reverse sweeps of ``G_t = dL/dS_t`` that give dk,
  dv, dw (from ``G_t`` and ``S_{t-1}``) and the start state's gradient;
  the kernel keeps S every ``BWD_TILE`` steps and recomputes each tile's
  states from there; its plain version is :func:`rwkv6_bwd_plain`.

The source states the math and the design of both.  :func:`grad_agreement`
holds the backward kernels against autograd of :func:`rwkv6_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..mpc.errors import ShapeContractError
from . import _build, work

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
    are read as they are.  Differentiable: under autograd it runs through
    :class:`WKV6`, whose backward is :func:`rwkv6_bwd`.
    """
    _check(r, k, v, w, u, state0)
    if k.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rwkv6 runs on cpu or cuda, not {k.device}")
    ops = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in ops):
        return WKV6.apply(r, k, v, w, u, state0)
    return _forward(r, k, v, w, u, state0)


def _check_kernel(r, k, v, w) -> None:
    """What the CUDA kernels (forward and backward) take beyond
    :func:`_check`: K = V = 64 and unit stride along the head dim."""
    dk, dv = k.shape[-1], v.shape[-1]
    if dk != HEAD_SIZE or dv != HEAD_SIZE:
        raise ShapeContractError(
            f"the rwkv6 kernel takes K = V = {HEAD_SIZE}, got K {dk}, V {dv}",
            shapes=(k.shape, v.shape))
    if any(x.stride(3) != 1 for x in (r, k, v, w)):
        raise ValueError("rwkv6 needs unit stride along the head dim")


def _forward(r, k, v, w, u, state0):
    """The plain version on the CPU, else the kernel, counted; on
    ``meta``, empty outputs whose work goes to the tally (:mod:`.work`)."""
    if k.device.type == "meta":
        b, t, h, dk = k.shape
        work.record("rwkv6", *work.wkv_work(b, t, h, k.element_size(),
                                            state0 is not None, d=dk))
        return (k.new_empty((b, t, h, v.shape[-1]), dtype=torch.float32),
                k.new_empty((b, h, dk, v.shape[-1]), dtype=torch.float32))
    if k.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, state0=state0)
    _check_kernel(r, k, v, w)
    b, t, h, dk = k.shape
    dv = v.shape[-1]
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
    _build.count(rwkv6)
    return out, state


rwkv6.launches = 0


class WKV6(torch.autograd.Function):
    """The WKV-6 recurrence with its hand-written backward.  The forward
    saves its operands only (no state per step); the backward recomputes
    the states in its sweeps.  Under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass, and is counted again."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, state = _forward(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        grads = rwkv6_bwd(r, k, v, w, u, dout, state0=state0, dstate=dstate)
        return grads


# The backward kernel against autograd of the plain forward on the same
# operands (see :func:`grad_agreement`): flash attention's backward limits,
# per gradient.  fp32: 1e-4 per element of |ref| plus its row's rms plus a
# tenth of the gradient's rms, and 1e-5 in relative Frobenius norm (sums in
# another order).  bf16 gradients (rounded once from fp32):
# 2^-6 per element and 2^-7 in relative Frobenius norm.
GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
# steps per tile of the backward kernel's sweeps (csrc/rwkv6_bwd.cu): the
# forward sweep keeps the state at the start of each, from which the reverse
# sweep recomputes the tile's states for dw
BWD_TILE = 16
# the chunked instance's steps per chunk (its sequential sweeps step over
# chunks) and per sub-chunk (its exact pairwise gates stay inside one)
CHUNK = 64
SUB_CHUNK = 16


def grad_agreement(got, ref) -> dict:
    """How far the backward's ``got = (dr, dk, dv, dw, du, dstate0)`` lies
    from ``ref`` (autograd of :func:`rwkv6_plain` on the same operands),
    per gradient and over all, in the form and limits of
    :func:`~repro_torch.kernels.flash_attention.grad_agreement`; a
    ``dstate0`` that is None on both sides is left out."""
    from .flash_attention import grad_agreement as _grad_agreement

    names = tuple(n for n, g, w in zip(GRAD_NAMES, got, ref, strict=True)
                  if g is not None or w is not None)
    pick = [(g, w) for g, w in zip(got, ref, strict=True)
            if g is not None or w is not None]
    return _grad_agreement([g for g, _ in pick], [w for _, w in pick],
                           names=names)


def rwkv6_bwd_plain(r, k, v, w, u, dout, *, state0=None, dstate=None):
    """The plain version of :func:`rwkv6_bwd` on any device: a forward
    sweep that keeps every state ``S_{t-1}`` and gives dr, then a reverse
    sweep of ``G_t`` that gives dk, dv, dw and the start state's gradient;
    fp32 sweeps, fp64 sums for du and the bonus terms."""
    rwkv6_bwd_plain.calls += 1
    dtype = k.dtype
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uf = u.float()
    dout = dout.float()
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    decay = torch.exp(-torch.exp(w))
    vd = torch.einsum("bthv,bthv->bth", v.double(), dout.double())[..., None]
    bonus = torch.einsum("bthk,hk,bthk->bth", r.double(), uf.double(),
                         k.double()).float()[..., None]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=k.device)
         if state0 is None else state0.float().clone())
    states = []                                  # S_{t-1} for every t
    ys = torch.empty((b, t, h, dk), dtype=torch.float32, device=k.device)
    for i in range(t):
        states.append(s)
        ys[:, i] = torch.einsum("bhkv,bhv->bhk", s, dout[:, i])
        s = s * decay[:, i, :, :, None] + k[:, i, :, :, None] * v[:, i, :, None, :]
    dr = ys + (uf.double() * k.double() * vd).float()
    g = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=k.device)
         if dstate is None else dstate.float().clone())
    yk = torch.empty_like(ys)
    dvv = torch.empty((b, t, h, dv), dtype=torch.float32, device=k.device)
    dd = torch.empty_like(ys)                    # dL/dd_t = rowsum(G_t o S_{t-1})
    for i in reversed(range(t)):
        yk[:, i] = torch.einsum("bhkv,bhv->bhk", g, v[:, i])
        dvv[:, i] = (torch.einsum("bhk,bhkv->bhv", k[:, i], g)
                     + bonus[:, i] * dout[:, i])
        dd[:, i] = (g * states[i]).sum(-1)
        g = g * decay[:, i, :, :, None] + r[:, i, :, :, None] * dout[:, i, :, None, :]
    dk_ = yk + (uf.double() * r.double() * vd).float()
    dw = -torch.exp(w) * decay * dd
    du = torch.einsum("bthk,bthk,bth->hk", r.double(), k.double(), vd[..., 0])
    return (dr.to(dtype), dk_.to(dtype), dvv.to(dtype), dw.to(dtype),
            du.to(u.dtype), None if state0 is None else g)


rwkv6_bwd_plain.calls = 0


def _chunks(x: torch.Tensor, n: int, pad: int) -> torch.Tensor:
    """``[B, T, H, D]`` as ``[B, H, n, CHUNK, D]``, zero past T."""
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return x.reshape(x.shape[0], n, CHUNK, x.shape[2], x.shape[3]).permute(
        0, 3, 1, 2, 4)


def _exclusive(x: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Running sums along dim -2 that leave out the step itself: the sum
    over earlier steps, or with ``reverse`` over later ones."""
    if reverse:
        return _exclusive(x.flip(-2)).flip(-2)
    return torch.cat([torch.zeros_like(x[..., :1, :]),
                      x[..., :-1, :].cumsum(-2)], dim=-2)


# pairs (s, s2), s < s2, of a sub-chunk's steps: for each i, those with
# s < i < s2 (the dw terms that straddle step i)
_STRADDLE = torch.tensor([[[s < i < s2 for s in range(SUB_CHUNK)]
                           for s2 in range(SUB_CHUNK)]
                          for i in range(SUB_CHUNK)])


def _chunk_scan(tot, x, init, *, reverse=False):
    """Walk the chunks (dim 2) of ``state_next = diag(e^tot_c) state + x_c``
    from ``init``, forward or in ``reverse``: the state at each chunk's
    start (forward) or end (reverse), and the state after the walk."""
    n = x.shape[2]
    states = [None] * n
    s = init
    for c in (reversed(range(n)) if reverse else range(n)):
        states[c] = s
        s = torch.exp(tot[:, :, c])[..., None] * s + x[:, :, c]
    return states, s


def _gate_sums(lq):
    """The sums of log-decay over a sub-chunk's steps before and after each
    step (dim -2), each leaving the step out."""
    return _exclusive(lq), _exclusive(lq, reverse=True)


def rwkv6_bwd_chunked_plain(r, k, v, w, u, dout, *, state0=None, dstate=None):
    """The plain version of the ``chunked`` backward instance, on any
    device: the arithmetic of ``csrc/rwkv6_bwd.cu``'s chunked kernels in
    plain torch (float64 operands stay float64, the rest run in fp32, the
    bonus terms and du in fp64), for the tests and ``chip_smoke.py``.

    With log-decay λ_t = -exp(w_t), per (batch, head):

    1. S at the start of every ``CHUNK`` steps, forward over chunks:
       ``S_{c+1} = diag(e^{Σλ}) S_c + (k ∘ e^{λ after s})ᵀ v``;
    2. G (= dL/dS) at the end of every chunk, backward over chunks:
       ``G_{c-1} = diag(e^{Σλ}) G_c + (r ∘ e^{λ before j})ᵀ dout``
       (``dstate0`` is G before chunk 0);
    3. per chunk, S at the start and G at the end of each ``SUB_CHUNK``
       steps by the same two recurrences, then per sub-chunk q, with
       ``pex``/``X`` the sums of λ over its steps before/after a step:
       ``dr = e^{pex} ∘ (dout S_qᵀ) + Σ_{s<i} A_is γ k_s + u k (v·dout)``,
       ``dk = e^{X} ∘ (v G_qᵀ) + Σ_{s>i} A_si γ r_s + u r (v·dout)``,
       ``dv = (k e^{X}) G_q + Σ_{s>i} P_si dout_s + a_i dout_i``, where
       ``A = dout vᵀ`` and ``γ(s2, s) = e^{Σ λ strictly between}`` is the
       exact pairwise gate inside the sub-chunk, ``P_{s2 s} = Σ_k r k γ``;
       and ``d_i rowsum(G_i ∘ S_{i-1})`` as ``e^{Σλ} rowsum(S_q ∘ G_q)``
       plus the suffix sum of ``r ∘ dr``'s state term, the prefix sum of
       ``k ∘ dk``'s, and the pairs ``s < i < s2`` of the sub-chunk (each
       gated by the decays strictly between s and s2: nothing is divided
       by a decay and no sum runs past the sub-chunk); ``dw = λ ∘ that``.

    Every gate is e to a sum of λ ≤ 0 over the steps it spans, so no
    exponential overflows at any decay.  (The tests plant faults by
    wrapping :func:`_chunk_scan` and :func:`_gate_sums`.)
    """
    rwkv6_bwd_chunked_plain.calls += 1
    dtype = k.dtype
    cd = torch.float64 if dtype == torch.float64 else torch.float32
    b, t, h, dk_ = k.shape
    dv_ = v.shape[-1]
    dev = k.device
    vd = torch.einsum("bthv,bthv->bth", v.double(), dout.double())
    av = torch.einsum("bthk,hk,bthk->bth", r.double(), u.double(),
                      k.double()).to(cd)
    rf, kf, vf, wf, of = (x.to(cd) for x in (r, k, v, w, dout))
    lam = -torch.exp(wf)
    n = -(-t // CHUNK)
    pad = n * CHUNK - t
    rc, kc, vc, lc, oc = (_chunks(x, n, pad) for x in (rf, kf, vf, lam, of))
    avc = _chunks(av[..., None], n, pad)[..., 0]
    zeros = torch.zeros((b, h, dk_, dv_), dtype=cd, device=dev)
    # 1, 2: the chunk states
    tot = lc.sum(-2)                                          # [B,H,n,K]
    kt = kc * torch.exp(_exclusive(lc, reverse=True))
    rt = rc * torch.exp(_exclusive(lc))
    starts, _ = _chunk_scan(tot, kt.transpose(-1, -2) @ vc,
                            zeros if state0 is None else state0.to(cd))
    ends, g = _chunk_scan(tot, rt.transpose(-1, -2) @ oc,
                          zeros if dstate is None else dstate.to(cd),
                          reverse=True)
    ds0 = None if state0 is None else g
    if n == 0:
        z = torch.zeros((b, 0, h, dk_), dtype=dtype, device=dev)
        return (z, z.clone(), torch.zeros_like(v), z.clone(),
                torch.zeros_like(u), ds0)
    # 3: per chunk (all at once), per sub-chunk
    sq = [torch.stack(starts, 2)]                             # [B,H,n,K,V]
    gq = [torch.stack(ends, 2)]
    subs = []
    for q in range(CHUNK // SUB_CHUNK):
        sl = slice(q * SUB_CHUNK, (q + 1) * SUB_CHUNK)
        lq = lc[..., sl, :]
        pex, x = _gate_sums(lq)
        subs.append({"sl": sl, "pex": pex, "pin": pex + lq, "x": x,
                     "tot": torch.exp(lq.sum(-2))[..., None]})
    for q, sub in enumerate(subs[:-1]):
        sl = sub["sl"]
        kb = kc[..., sl, :] * torch.exp(sub["x"])
        sq.append(sub["tot"] * sq[q] + kb.transpose(-1, -2) @ vc[..., sl, :])
    for q in reversed(range(1, len(subs))):
        sub = subs[q]
        sl = sub["sl"]
        rb = rc[..., sl, :] * torch.exp(sub["pex"])
        gq.insert(0, sub["tot"] * gq[0] + rb.transpose(-1, -2) @ oc[..., sl, :])
    straddle = _STRADDLE.to(device=dev, dtype=cd)
    dr, dk, dv, ddd = (torch.empty_like(kc) for _ in range(4))
    for q, sub in enumerate(subs):
        sl, pex, pin, x = sub["sl"], sub["pex"], sub["pin"], sub["x"]
        rq, kq, vq, oq = (y[..., sl, :] for y in (rc, kc, vc, oc))
        s_q, g_q = sq[q], gq[q]
        dr_nd = torch.exp(pex) * (oq @ s_q.transpose(-1, -2))
        dk_nd = torch.exp(x) * (vq @ g_q.transpose(-1, -2))
        dv_nd = (kq * torch.exp(x)) @ g_q
        a = oq @ vq.transpose(-1, -2)                         # [..., s2, s]
        later = torch.ones(SUB_CHUNK, SUB_CHUNK, dtype=torch.bool,
                           device=dev).tril(-1)               # s < s2
        span = pex[..., :, None, :] - pin[..., None, :, :]    # [..., s2, s, K]
        gam = torch.exp(torch.where(later[..., None], span,
                                    torch.full_like(span, -torch.inf)))
        dr_d = torch.einsum("...ts,...tsk,...sk->...tk", a, gam, kq)
        dk_d = torch.einsum("...ts,...tsk,...tk->...sk", a, gam, rq)
        p = torch.einsum("...tk,...sk,...tsk->...ts", rq, kq, gam)
        dv_d = (torch.einsum("...ts,...tv->...sv", p, oq)
                + avc[..., sl, None] * oq)
        pairs = gam * rq[..., :, None, :] * kq[..., None, :, :] * a[..., None]
        ddd[..., sl, :] = (
            sub["tot"][..., 0][..., None, :] * (s_q * g_q).sum(-1)[..., None, :]
            + _exclusive(rq * dr_nd, reverse=True)
            + _exclusive(kq * dk_nd)
            + torch.einsum("its,...tsk->...ik", straddle, pairs))
        dr[..., sl, :] = dr_nd + dr_d
        dk[..., sl, :] = dk_nd + dk_d
        dv[..., sl, :] = dv_nd + dv_d

    def unchunk(y):
        return y.permute(0, 2, 3, 1, 4).reshape(b, n * CHUNK, h, -1)[:, :t]

    dr, dk, dv, ddd = (unchunk(y) for y in (dr, dk, dv, ddd))
    vd = vd[..., None]
    dr = dr + (u.double() * k.double() * vd).to(cd)
    dk = dk + (u.double() * r.double() * vd).to(cd)
    dw = lam * ddd
    du = torch.einsum("bthk,bthk,bth->hk", r.double(), k.double(), vd[..., 0])
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dw.to(dtype),
            du.to(u.dtype), ds0)


rwkv6_bwd_chunked_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _bwd_lib(instance: str):
    lib = _build.load("rwkv6_bwd")
    fn = (lib.rwkv6_bwd_chunked_launch if instance == "chunked"
          else lib.rwkv6_bwd_launch)
    fn.argtypes = ([ctypes.c_void_p] * (21 if instance == "chunked" else 18)
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# the backward's instances (both in csrc/rwkv6_bwd.cu)
BWD_INSTANCES = ("chunked", "sweep")


def choose_bwd_instance(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor) -> str:
    """The backward kernel that serves these operands on the card:
    ``"chunked"`` (chunks of ``CHUNK`` steps, the products on TF32 wgmma)
    for bf16 operands, the training path; ``"sweep"`` (the sequential
    recurrence on fp32 CUDA cores, held to the fp32 limits) for fp32.  A
    pure function of the dtype, so the CPU tests can ask it."""
    return "chunked" if k.dtype == torch.bfloat16 else "sweep"


def rwkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor, *,
              state0: Optional[torch.Tensor] = None,
              dstate: Optional[torch.Tensor] = None):
    """``(dr, dk, dv, dw, du, dstate0)`` of ``(out, state) = rwkv6(r, k, v,
    w, u, state0=state0)`` given ``dout [B,T,H,V]``, the gradient of the
    output, and ``dstate [B,H,K,V]`` (fp32, or None for 0), that of the
    final state.  dr, dk, dv and dw come in the operands' dtype, du in
    u's; ``dstate0`` (fp32) is None when ``state0`` is.

    On the card (K = V = 64) :func:`choose_bwd_instance` picks ``chunked``
    or ``sweep``, the kernels of ``csrc/rwkv6_bwd.cu`` in one launch,
    counted in ``rwkv6_bwd.launches`` and ``.instances``; a CPU tensor takes
    :func:`rwkv6_bwd_plain`.  Nothing falls back.
    """
    _check(r, k, v, w, u, state0)
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    if tuple(dout.shape) != (b, t, h, dv) or dout.device != k.device:
        raise ShapeContractError(
            f"rwkv6_bwd needs dout {(b, t, h, dv)} on {k.device}, got "
            f"{tuple(dout.shape)} on {dout.device}", shapes=(dout.shape,))
    if dstate is not None and (tuple(dstate.shape) != (b, h, dk, dv)
                               or dstate.device != k.device):
        raise ShapeContractError(
            f"rwkv6_bwd needs dstate {(b, h, dk, dv)}, got "
            f"{tuple(dstate.shape)}", shapes=(dstate.shape,))
    if k.device.type == "meta":
        work.record("rwkv6_bwd", *work.wkv_bwd_work(b, t, h, k.element_size(),
                                                    d=dk))
        return (r.new_empty(r.shape), k.new_empty(k.shape),
                v.new_empty(v.shape), w.new_empty(w.shape),
                u.new_empty(u.shape),
                None if state0 is None else state0.new_empty(state0.shape))
    if k.device.type == "cpu":
        return rwkv6_bwd_plain(r, k, v, w, u, dout, state0=state0,
                               dstate=dstate)
    if k.device.type != "cuda":
        raise ValueError(f"rwkv6_bwd runs on cpu or cuda, not {k.device}")
    instance = choose_bwd_instance(r, k, v, w)
    grads = _bwd_launch(r, k, v, w, u, dout, state0=state0, dstate=dstate,
                        instance=instance)
    _build.count(rwkv6_bwd, instance)
    return grads


def _bwd_launch(r, k, v, w, u, dout, *, state0=None, dstate=None,
                instance: str):
    """Launch one backward instance on checked CUDA operands, uncounted:
    the wrapper's path after :func:`choose_bwd_instance`, and the way to
    time or check an instance the chooser would not pick (``chunked`` on
    fp32 operands: its TF32 products miss the fp32 limits)."""
    if instance not in BWD_INSTANCES:
        raise ValueError(f"unknown rwkv6_bwd instance {instance!r}; known: "
                         f"{BWD_INSTANCES}")
    _check_kernel(r, k, v, w)
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    dev, dtype = k.device, k.dtype
    uf = u.float().contiguous()
    do = dout.float().contiguous()
    s0 = None if state0 is None else state0.contiguous()
    ds = None if dstate is None else dstate.float().contiguous()
    dr, dkk, dvv, dw = (torch.empty((b, t, h, HEAD_SIZE), dtype=dtype,
                                    device=dev) for _ in range(4))
    du = torch.empty((h, dk), dtype=torch.float32, device=dev)
    ds0 = (None if state0 is None else
           torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev))
    # scratch.  sweep: S at the start of every BWD_TILE steps (the forward
    # sweep's, from which the reverse sweep recomputes each tile's states)
    # and du's partial sums per (batch, head).  chunked: S at the start and
    # G at the end of every CHUNK steps, each chunk's products and sums of
    # log-decay (S role, G role), du's partial sums per (batch, chunk,
    # head).  Both: v_t . dout_t and the bonus scalar per (batch, step,
    # head)
    if instance == "chunked":
        nc = -(-t // CHUNK)
        shapes = ((b, nc, h, dk, dv), (b, nc, h, dk, dv),
                  (b, nc, 2, h, dk, dv), (b, nc, 2, h, dk))
        flat = torch.empty(sum(math.prod(x) for x in shapes),
                           dtype=torch.float32, device=dev)
        scratch = [x.view(shape) for x, shape in zip(
            flat.split([math.prod(x) for x in shapes]), shapes, strict=True)]
        du_part = torch.empty((b, nc, h, dk), dtype=torch.float64, device=dev)
    else:
        scratch = [torch.empty((b, -(-t // BWD_TILE), h, dk, dv),
                               dtype=torch.float32, device=dev)]
        du_part = torch.empty((b, h, dk), dtype=torch.float64, device=dev)
    vd = torch.empty((b, t, h), dtype=torch.float64, device=dev)
    av = torch.empty((b, t, h), dtype=torch.float32, device=dev)
    strides = [st for x in (r, k, v, w) for st in x.stride()[:3]]

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_lib(instance)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), ptr(s0), do.data_ptr(), ptr(ds), dr.data_ptr(),
            dkk.data_ptr(), dvv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ptr(ds0), *(x.data_ptr() for x in scratch), du_part.data_ptr(),
            vd.data_ptr(), av.data_ptr(), _DTYPES[dtype], b, t, h, dk, dv,
            *strides, stream)
    _build.check(err, f"rwkv6_bwd ({instance})")
    return dr, dkk, dvv, dw, du.to(u.dtype), ds0


rwkv6_bwd.launches = 0
rwkv6_bwd.instances = dict.fromkeys(BWD_INSTANCES, 0)

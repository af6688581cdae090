"""GQA softmax attention on the card: the serve path's prefill attention.

``flash_attention(q, k, v)`` takes q ``[B, T, Hq, D]`` and k, v
``[B, S, Hkv, D]`` (``Hq`` a multiple of ``Hkv``) and returns
``[B, T, Hq, D]`` in q's dtype.  Query row ``i`` sits at position
``q_offset + i``; when causal it sees keys ``j <= q_offset + i``.  Prefill
uses ``q_offset = 0`` with ``T == S``, where the Pallas kernel (causal mask
aligned top-left) and ``ref.flash_attention_ref`` (aligned bottom-right)
agree.

Port of ``repro/kernels/flash_attention.py``.  The CUDA kernels
(``csrc/flash_attention.cu``) give each block one (batch, q-head, q tile),
loop over kv tiles with an fp32 online softmax, skip tiles above the
diagonal and read the ``[B, T, H, D]`` layout through its strides.  Three
instances, of which :func:`choose_instance` picks one before any launch:

* ``wgmma``: bf16 on Hopper's wgmma, fed by TMA through an mbarrier ring,
  for operands whose bases and strides are 16-byte aligned (the serve
  path's q, k, v);
* ``mma_sync``: bf16 on ``mma.sync`` for the rest (rows that are not
  16-byte aligned);
* ``cuda_core``: fp32 on the CUDA cores.

The source states the bound and design.  Head dims 32, 64 and 128.

The wrapper checks its operands, allocates the output with
``torch.empty``, launches on the current stream and counts the launch in
``flash_attention.launches`` and ``flash_attention.instances[name]``.  A
CPU tensor takes the plain version (:func:`flash_attention_plain`, which
counts its calls in ``flash_attention_plain.calls``); a CUDA tensor
launches the chosen kernel or raises: nothing falls back.

Training.  When autograd records (grad enabled and an operand that
requires grad), :func:`flash_attention` runs through
:class:`FlashAttention`: the forward launch also writes each row's
log-sum-exp (``lse [B, Hq, T]``, fp32; counted in
``flash_attention.lse_launches``, which the serve path leaves at 0), and
the backward is :func:`flash_attention_bwd`, the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (launches in ``flash_attention_bwd
.launches`` and ``.instances``), which replace the XLA autodiff of the
reference's ``attention_chunked``.  :func:`choose_bwd_instance` picks
``wgmma`` (bf16 at D 64 and 128 with aligned rows: TMA and wgmma, the
training path), ``mma_sync`` (other bf16) or ``cuda_core`` (fp32);
``_bwd_launch(..., instance=...)`` runs one it would not pick.
On the CPU both directions take their plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`).
:func:`grad_agreement` holds the backward kernel against its plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..mpc.errors import ShapeContractError
from . import _build, work

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)       # the kernel's template instances
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' instances, as the C launcher numbers them
_INSTANCE_IDS = {"wgmma": 2, "mma_sync": 1, "cuda_core": 0}
INSTANCES = tuple(_INSTANCE_IDS)

# The kernel against its plain version on the same operands (see
# :func:`agreement`).  fp32: 2e-5 absolute and relative.  A bf16 output
# carries 8 significant bits, and the two round differently (the kernel
# also rounds P to bf16 for the P V product), so an element may differ by
# 2^-6 of |ref| plus its row's rms over D (two ULP of |ref| at least), and
# the whole by 2^-8 in relative Frobenius norm.
FP32_TOL = 2e-5
BF16_ELEMENT_TOL = 2.0 ** -6
BF16_FROBENIUS_TOL = 2.0 ** -8

# The backward kernel against its plain version (see :func:`grad_agreement`),
# per gradient.  An element is held to a share of |ref| plus its row's rms
# over D plus a tenth of the whole gradient's rms: where the exact gradient
# of a row cancels to 0 (a causal row 0 sees one key, so its dS = dP - D =
# 0), both versions are left with rounding noise and the row has no scale
# of its own.  fp32: 1e-4 per element and 1e-5 in relative Frobenius norm
# (sums in another order).  bf16: the kernel rounds P and dS to bf16 for
# the products and each gradient to bf16 at the end, so 2^-6 per element
# and 2^-7 in relative Frobenius norm.
GRAD_FP32_FROBENIUS_TOL = 1e-5
GRAD_FP32_ELEMENT_TOL = 1e-4
GRAD_BF16_ELEMENT_TOL = 2.0 ** -6
GRAD_BF16_FROBENIUS_TOL = 2.0 ** -7
GRAD_FLOOR = 0.1
GRAD_NAMES = ("dq", "dk", "dv")


def agreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``got`` lies from ``ref``, the plain version's output on the
    same operands, in ref's dtype: ``max_abs_err``; ``worst``, the largest
    element error over its limit; ``rel_frob``, ``||got - ref|| / ||ref||``;
    and ``ok``, whether both stay within the limits above."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if ref.dtype == torch.bfloat16:
        row_rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
        limit = BF16_ELEMENT_TOL * (r.abs() + row_rms)
        frob_tol = BF16_FROBENIUS_TOL
    else:
        limit = FP32_TOL + FP32_TOL * r.abs()
        frob_tol = float("inf")
    if not err.numel():
        return {"max_abs_err": 0.0, "worst": 0.0, "rel_frob": 0.0, "ok": True}
    # an exact 0 passes a 0 limit (rows that see no key); NaN fails
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    worst = float(ratio.max())
    rel_frob = float(err.norm() / r.norm().clamp_min(1e-30))
    return {"max_abs_err": float(err.max()), "worst": worst,
            "rel_frob": rel_frob, "ok": worst <= 1.0 and rel_frob <= frob_tol}


def grad_agreement(got, ref, *, names=GRAD_NAMES) -> dict:
    """How far the backward's ``got = (dq, dk, dv)`` lies from ``ref``, the
    plain version's on the same operands: per gradient ``max_abs_err``,
    ``worst`` (the largest element error over its limit), ``rel_frob`` and
    ``ok`` (within the limits above for ref's dtype), and ``ok`` over all
    of them.  ``names`` names the gradients (the recurrence kernels' own
    backwards are held to the same limits)."""
    out = {}
    for name, g, r in zip(names, got, ref, strict=True):
        gf, rf = g.float(), r.float()
        err = (gf - rf).abs()
        if not err.numel():
            out[name] = {"max_abs_err": 0.0, "worst": 0.0, "rel_frob": 0.0,
                         "ok": True}
            continue
        scale = (rf.abs() + rf.pow(2).mean(dim=-1, keepdim=True).sqrt()
                 + GRAD_FLOOR * rf.pow(2).mean().sqrt())
        if r.dtype == torch.bfloat16:
            limit = GRAD_BF16_ELEMENT_TOL * scale
            frob_tol = GRAD_BF16_FROBENIUS_TOL
        else:
            limit = GRAD_FP32_ELEMENT_TOL * scale
            frob_tol = GRAD_FP32_FROBENIUS_TOL
        # an exact 0 passes a 0 limit (rows that see no key); NaN fails
        ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
        worst = float(ratio.max())
        norm = float(rf.norm())
        rel_frob = float(err.norm()) / norm if norm else float(err.norm())
        out[name] = {"max_abs_err": float(err.max()), "worst": worst,
                     "rel_frob": rel_frob,
                     "ok": worst <= 1.0 and rel_frob <= frob_tol}
    out["ok"] = all(out[name]["ok"] for name in names)
    return out


def _visible(t: int, s: int, causal: bool, q_offset: int, device):
    """``[T, S]`` bool: which keys each query row sees."""
    if not causal:
        return torch.ones((t, s), dtype=torch.bool, device=device)
    q_pos = q_offset + torch.arange(t, device=device)[:, None]
    return q_pos >= torch.arange(s, device=device)[None, :]


def _heads_first(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """``[B, T, H, D]`` as fp32 ``[B, H * group, T, D]``, each head
    repeated ``group`` times (GQA's kv heads against the q heads)."""
    x = x.float()
    if group > 1:
        x = x.repeat_interleave(group, dim=2)
    return x.transpose(1, 2)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, q_offset: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """The plain version: materialised softmax attention in fp32 with GQA
    and the causal mask ``q_offset + i >= j`` (``attention_direct``'s
    semantics), on any device.  A row that sees no key is 0, as in the
    kernel.  With ``return_lse`` also each row's log-sum-exp of its scaled
    logits, ``[B, Hq, T]`` fp32, +inf for a row that sees no key (the
    kernel's training output)."""
    flash_attention_plain.calls += 1
    t, hq, d = q.shape[1], q.shape[2], q.shape[3]
    s, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    group = hq // hkv
    qf, kf, vf = _heads_first(q), _heads_first(k, group), _heads_first(v, group)
    logits = (qf @ kf.transpose(-1, -2)) * scale                  # [B,Hq,T,S]
    visible = _visible(t, s, causal, q_offset, q.device)
    seen = visible.any(-1)                                        # [T]
    if causal:
        logits = logits.masked_fill(~visible, NEG_INF)
        probs = torch.softmax(logits, dim=-1) * seen[:, None]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = (probs @ vf).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1).masked_fill(~seen, float("inf"))
    return out, lse


flash_attention_plain.calls = 0


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              q_offset: int = 0,
                              scale: Optional[float] = None):
    """The plain version of the backward: ``(dq, dk, dv)`` in q's dtype by
    the kernel's recompute formulas in fp32, on any device.  ``P = exp(S
    scale - lse)`` on the visible pairs, ``D = rowsum(dO o O)``, ``dV =
    P^T dO``, ``dS = P o (dO V^T - D)``, ``dQ = dS K scale``, ``dK = dS^T Q
    scale``, dK and dV summed over each kv-head's group of q-heads."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    group = hq // hkv
    qf, kf, vf = _heads_first(q), _heads_first(k, group), _heads_first(v, group)
    of, dof = _heads_first(o), _heads_first(do)
    logits = (qf @ kf.transpose(-1, -2)) * scale                  # [B,Hq,T,S]
    visible = _visible(t, s, causal, q_offset, q.device)
    p = torch.where(visible, torch.exp(logits - lse.float()[..., None]), 0.0)
    dv = p.transpose(-1, -2) @ dof                                # [B,Hq,S,D]
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale

    def kv_grad(x):     # the group's q-heads summed onto their kv-head
        return x.reshape(b, hkv, group, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), kv_grad(dk).to(q.dtype),
            kv_grad(dv).to(q.dtype))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def choose_instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that serves these operands on the card.

    ``"cuda_core"`` for fp32.  For bf16, ``"wgmma"`` when every operand's
    base address is 16-byte aligned and its batch, row and head strides are
    multiples of 8 elements (TMA moves whole 16-byte units), else
    ``"mma_sync"``.  A pure function of dtype, strides and pointers, so the
    CPU tests can ask it.
    """
    if q.dtype != torch.bfloat16:
        return "cuda_core"
    for x in (q, k, v):
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            return "mma_sync"
    return "wgmma"


def choose_bwd_instance(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> str:
    """The backward kernel that serves these operands on the card.

    ``"cuda_core"`` for fp32.  For bf16, ``"wgmma"`` at head dims 64 and
    128 when :func:`choose_instance` would take the forward's ``wgmma``
    instance (16-byte aligned bases, strides multiples of 8 elements), else
    ``"mma_sync"`` (D = 32, and rows that are not 16-byte aligned, which
    the wrapper copies).  ``do`` and ``o`` do not choose: the wrapper copies
    one whose rows are not aligned.  A pure function of dtype, head dim,
    strides and pointers, so the CPU tests can ask it.
    """
    instance = choose_instance(q, k, v)
    if instance == "wgmma" and q.shape[-1] not in WGMMA_BWD_HEAD_DIMS:
        return "mma_sync"
    return instance


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention takes fp32 or bf16 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
        if x.ndim != 4:
            raise ShapeContractError(
                f"flash_attention takes [B, T, H, D] operands, got "
                f"{tuple(x.shape)}", shapes=(q.shape, k.shape, v.shape))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention operands disagree in dtype: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention operands on {q.device}, "
                         f"{k.device} and {v.device}")
    b, _, hq, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or k.shape[2] < 1 or hq % k.shape[2]):
        raise ShapeContractError(
            f"flash_attention needs q [B,T,Hq,D] and k, v [B,S,Hkv,D] with "
            f"Hq a multiple of Hkv: got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}", shapes=(q.shape, k.shape, v.shape))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` per (batch, q-head), GQA, in q's dtype.

    ``q: [B, T, Hq, D]``, ``k, v: [B, S, Hkv, D]``, fp32 or bf16, on one
    device; ``scale`` defaults to ``D ** -0.5``.  On the card the head dim
    must be 32, 64 or 128 and D must have unit stride; the other strides
    are read as they are.  Differentiable: under autograd it runs through
    :class:`FlashAttention`, whose backward is :func:`flash_attention_bwd`.
    """
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, q_offset, scale)
    return _forward(q, k, v, causal=causal, q_offset=q_offset, scale=scale)[0]


def _forward(q, k, v, *, causal: bool, q_offset: int, scale: Optional[float],
             with_lse: bool = False):
    """``(out, lse or None)``: the plain version on the CPU, else the
    chosen kernel, counted (and in ``lse_launches`` when it writes lse);
    on ``meta``, empty outputs whose work goes to the tally
    (:mod:`.work`)."""
    if q.device.type == "meta":
        nbytes, flops, _ = work.attn_work(q, k, causal, q_offset)
        work.record("flash_attention", nbytes, flops)
        lse = (q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                           dtype=torch.float32) if with_lse else None)
        return q.new_empty(q.shape), lse
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset, scale=scale,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                     scale=scale), None
    instance = choose_instance(q, k, v)
    lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    out = _launch(q, k, v, instance=instance, causal=causal, q_offset=q_offset,
                  scale=scale, lse=lse)
    _build.count(flash_attention, instance)
    if with_lse:
        flash_attention.lse_launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Attention with its hand-written backward.  The forward saves q, k,
    v, the output and each row's log-sum-exp; the backward recomputes P
    from them in :func:`flash_attention_bwd` (no ``[T, S]`` tensor is
    kept).  Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass, and is counted again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, scale):
        out, lse = _forward(q, k, v, causal=causal, q_offset=q_offset,
                            scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, scale = ctx.attrs
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                         q_offset=q_offset, scale=scale)
        return dq, dk, dv, None, None, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            instance: str, causal: bool = True, q_offset: int = 0,
            scale: Optional[float] = None,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one instance on checked CUDA operands, uncounted: the
    wrapper's path after :func:`choose_instance`, and the way to time or
    check an instance the chooser would not pick.  ``lse``, when given, is
    a contiguous fp32 ``[B, Hq, T]`` buffer the kernel fills with each
    row's log-sum-exp."""
    if instance not in INSTANCES:
        raise ValueError(f"unknown flash_attention instance {instance!r}; "
                         f"known: {INSTANCES}")
    if (instance == "cuda_core") != (q.dtype == torch.float32):
        raise TypeError(f"the {instance} instance does not take {q.dtype}")
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ShapeContractError(
            f"the flash_attention kernel takes head dims {HEAD_DIMS}, got {d}",
            shapes=(q.shape, k.shape, v.shape))
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs unit stride along the head dim")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     _INSTANCE_IDS[instance], b, t, s, hq, hkv, d,
                     *strides, int(causal), int(q_offset), float(scale), stream)
    _build.check(err, f"flash_attention ({instance})")
    return out


flash_attention.launches = 0
flash_attention.instances = dict.fromkeys(INSTANCES, 0)
flash_attention.lse_launches = 0

# the backward's instances, as its C launcher numbers them
_BWD_INSTANCE_IDS = {"wgmma": 2, "mma_sync": 1, "cuda_core": 0}
BWD_INSTANCES = tuple(_BWD_INSTANCE_IDS)
WGMMA_BWD_HEAD_DIMS = (64, 128)
_WGMMA_BWD_ROWS = 128   # the wgmma instance's q tile: its scratch's row pad


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """x itself when its base and (batch, row, head) strides are 16-byte
    aligned with unit stride along D, else a contiguous copy: the bf16
    backward loads whole 16-byte rows."""
    if (x.stride(3) == 1 and not x.data_ptr() % 16
            and not any(st % 8 for st in x.stride()[:3])):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)`` given ``do``, the
    gradient of the output, and ``lse [B, Hq, T]`` (fp32), the forward's
    per-row log-sum-exp; each in its operand's shape and dtype.

    On the card (head dims 32, 64, 128) :func:`choose_bwd_instance` picks
    ``wgmma``, ``mma_sync`` or ``cuda_core``, three kernels in one launch
    counted in ``flash_attention_bwd.launches`` and ``.instances``; a CPU
    tensor takes :func:`flash_attention_bwd_plain`.  Nothing falls back.
    """
    _check(q, k, v)
    b, t, hq, d = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ShapeContractError(
                f"flash_attention_bwd needs {name} like q {tuple(q.shape)} "
                f"{q.dtype}, got {tuple(x.shape)} {x.dtype} on {x.device}",
                shapes=(q.shape, x.shape))
    if (tuple(lse.shape) != (b, hq, t) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ShapeContractError(
            f"flash_attention_bwd needs an fp32 lse {(b, hq, t)}, got "
            f"{lse.dtype} {tuple(lse.shape)}", shapes=(lse.shape,))
    if q.device.type == "meta":
        nbytes, flops, _ = work.bwd_work(q, k, causal, q_offset)
        work.record("flash_attention_bwd", nbytes, flops)
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    instance = choose_bwd_instance(q, k, v)
    grads = _bwd_launch(q, k, v, o, do, lse, instance=instance, causal=causal,
                        q_offset=q_offset, scale=scale)
    _build.count(flash_attention_bwd, instance)
    return grads


def _bwd_launch(q, k, v, o, do, lse, *, instance: str, causal: bool = True,
                q_offset: int = 0, scale: Optional[float] = None):
    """Launch one backward instance on checked CUDA operands, uncounted: the
    wrapper's path after :func:`choose_bwd_instance`, and the way to time
    or check an instance the chooser would not pick."""
    if instance not in BWD_INSTANCES:
        raise ValueError(f"unknown flash_attention_bwd instance {instance!r}; "
                         f"known: {BWD_INSTANCES}")
    if (instance == "cuda_core") != (q.dtype == torch.float32):
        raise TypeError(f"the {instance} backward does not take {q.dtype}")
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dims = WGMMA_BWD_HEAD_DIMS if instance == "wgmma" else HEAD_DIMS
    if d not in dims:
        raise ShapeContractError(
            f"the flash_attention_bwd {instance} kernel takes head dims "
            f"{dims}, got {d}", shapes=(q.shape, k.shape, v.shape))
    bf16 = q.dtype == torch.bfloat16
    ops = [_rows16(x) if bf16 or x.stride(3) != 1 else x
           for x in (q, k, v, o, do)]
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # the wgmma instance reads D and lse (log2 units) a whole q tile at a
    # time from scratch rows padded to its tile
    tpad = -(-t // _WGMMA_BWD_ROWS) * _WGMMA_BWD_ROWS if instance == "wgmma" else t
    delta = torch.empty((b, hq, tpad), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(delta) if instance == "wgmma" else None
    scale = d ** -0.5 if scale is None else scale
    strides = [st for x in (*ops, dq, dk, dv) for st in x.stride()[:3]]
    lse = lse.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib()(*(x.data_ptr() for x in ops), lse.data_ptr(),
                         delta.data_ptr(),
                         None if lse2 is None else lse2.data_ptr(), tpad,
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         _BWD_INSTANCE_IDS[instance], b, t, s, hq, hkv, d,
                         *strides, int(causal), int(q_offset), float(scale),
                         stream)
    _build.check(err, f"flash_attention_bwd ({instance})")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.instances = dict.fromkeys(BWD_INSTANCES, 0)

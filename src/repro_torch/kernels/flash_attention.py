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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..mpc.errors import ShapeContractError
from . import _build

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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: materialised softmax attention in fp32 with GQA
    and the causal mask ``q_offset + i >= j`` (``attention_direct``'s
    semantics), on any device.  A row that sees no key is 0, as in the
    kernel."""
    flash_attention_plain.calls += 1
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    group = hq // hkv
    qf = q.float().transpose(1, 2)                                # [B,Hq,T,D]
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)  # [B,Hq,S,D]
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    logits = (qf @ kf.transpose(-1, -2)) * scale                  # [B,Hq,T,S]
    if causal:
        q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
        visible = q_pos >= torch.arange(s, device=q.device)[None, :]
        logits = logits.masked_fill(~visible, NEG_INF)
        probs = torch.softmax(logits, dim=-1) * visible.any(-1)[:, None]
    else:
        probs = torch.softmax(logits, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


flash_attention_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
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
    are read as they are.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    instance = choose_instance(q, k, v)
    out = _launch(q, k, v, instance=instance, causal=causal, q_offset=q_offset,
                  scale=scale)
    flash_attention.launches += 1
    flash_attention.instances[instance] += 1
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            instance: str, causal: bool = True, q_offset: int = 0,
            scale: Optional[float] = None) -> torch.Tensor:
    """Launch one instance on checked CUDA operands, uncounted: the
    wrapper's path after :func:`choose_instance`, and the way to time or
    check an instance the chooser would not pick."""
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
                     _INSTANCE_IDS[instance], b, t, s, hq, hkv, d,
                     *strides, int(causal), int(q_offset), float(scale), stream)
    _build.check(err, f"flash_attention ({instance})")
    return out


flash_attention.launches = 0
flash_attention.instances = dict.fromkeys(INSTANCES, 0)

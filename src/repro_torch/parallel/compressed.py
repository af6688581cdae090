"""Gradient compression for the slow (inter-pod) axis: int8 all-reduce with
error feedback (1-bit-Adam-family trick, arXiv:1802.06058 lineage).

Quantize per-leaf to int8 with a shared absmax scale, psum the int8 payload
(summed as int32), dequantize, and fold the quantization residual into the
next step's gradient (error feedback keeps convergence unbiased).  Cuts
pod-to-pod gradient bytes 4x vs fp32 / 2x vs bf16 (the int32 sum here
carries 4 bytes an element on the wire; the payload's information is the
int8).

Port of ``repro/parallel/compressed.py``.  JAX names an axis of a
``shard_map``; the port takes a ``torch.distributed`` process group (or a
``DeviceMesh`` and one of its axis names) and runs the reference's steps in
its order with plain torch operations and two collectives per leaf: the
shared absmax by ``all_reduce(MAX)`` and the int32 sum by
``all_reduce(SUM)``.  On a card that is about eight eager passes over
every gradient; a fused quantize-with-feedback kernel is listed in
``ROADMAP.md`` as speed work.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(group, axis: Optional[str]):
    """The process group: ``group`` itself, or a ``DeviceMesh``'s group
    along ``axis``."""
    if axis is not None:
        return group.get_group(axis)
    return group


_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def _residual(g32: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``g32 - q·scale`` rounded once to fp32, as one fma rounds it (XLA
    fuses the reference's expression so): the product of a 24-bit and an
    8-bit significand and the difference are exact in fp64."""
    return (g32.to(torch.float64)
            - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def compress_leaf(g: torch.Tensor, e: Optional[torch.Tensor], pg) -> dict:
    """One leaf of :func:`compressed_psum`, the reference's steps in its
    order: ``g32 = g + e``; the shared absmax (``all_reduce(MAX)``) plus
    1e-12; ``scale = absmax / 127``; q, rounded half to even and clipped
    to ±127, as int8; the residual ``g32 - q·scale`` (one rounding); the
    int32 sum of the
    payloads (``all_reduce(SUM)``); ``out = summed·scale / n`` in g's
    dtype.  Returns every stage: the inputs ``g`` and ``e``, then
    ``g32``, ``scale``, ``q``, ``summed``, ``out`` and ``error``."""
    n = dist.get_world_size(pg)
    g32 = g.to(torch.float32)
    if e is not None:
        g32 = g32 + e
    # shared scale first (scalar max) so the int8 payloads are additive
    absmax = torch.max(torch.abs(g32))
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=pg)
    # XLA compiles the reference's absmax / 127 as a product with the
    # fp32 reciprocal: the same bits here
    scale = (absmax + 1e-12) * _INV_127
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    error = _residual(g32, q, scale)
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=pg)
    out = (summed.to(torch.float32) * scale / n).to(g.dtype)
    return {"g": g, "e": e, "g32": g32, "scale": scale, "q": q,
            "summed": summed, "out": out, "error": error}


def compressed_psum(tree: Mapping[str, torch.Tensor], group=None,
                    errors: Optional[Mapping[str, torch.Tensor]] = None, *,
                    axis: Optional[str] = None,
                    stages: Optional[dict] = None):
    """int8-compressed gradient all-reduce over ``group`` (a process group,
    None for the default one, or a ``DeviceMesh`` with ``axis``).

    ``tree``: ``{name: gradient}``; ``errors``: the same names' fp32
    residuals for error feedback (zeros when None).  Returns ``(reduced,
    new_errors)``: the mean over the group's ranks in each gradient's
    dtype, and the residuals ``g32 - q * scale``.  With ``stages`` (a
    dict), each leaf's :func:`compress_leaf` stages are put there under
    its name, for a caller that checks them."""
    pg = _group(group, axis)
    reduced, new_errors = {}, {}
    for name, g in tree.items():
        leaf = compress_leaf(g, None if errors is None else errors[name], pg)
        reduced[name], new_errors[name] = leaf["out"], leaf["error"]
        if stages is not None:
            stages[name] = leaf
    return reduced, new_errors

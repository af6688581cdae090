"""Selective SSM (Mamba) block for the Jamba hybrid — arXiv:2403.19887.

Port of ``repro/models/ssm.py``.  Recurrence (diagonal A):
``h_t = exp(Δ_t A)·h_{t-1} + Δ_t B_t x_t``, ``y_t = C_t·h_t + D·x_t``,
gated by silu(z).  Prefill runs the scan through
:func:`~repro_torch.kernels.selective_scan.selective_scan`: the
hand-written kernel on the card, the reference's chunked associative scan
(its plain version) on the CPU; under autograd its backward is the
hand-written ``selective_scan_bwd`` kernel on the card.  Decode carries
(conv window, ssm state) and takes one step in plain torch, as the JAX
package computes it in XLA.

The block's weights are a :class:`Mamba` module with the reference's key
names.  The reference's ``shard(...)`` annotation is left out: on one card
it does nothing.

The reference computes Δ at rank one (``x_dt [Di, 1]`` plus a bias,
broadcast over the channels).  A :class:`MambaConfig` with ``dt_rank`` R >
0 makes the block the published Jamba mixer: ``x_proj: Di -> R + 2N``
with no bias, split into Δ, B and C, Jamba's RMS norms of the three (at
``cfg.norm_eps``), then ``softplus(Δ dt_proj + dt_bias)`` with ``dt_proj
[R, Di]``; the scan and everything
after it are the same.  A port-only path: the JAX package has no such
mixer, and its ``SSMConfig`` (a verbatim copy here) no such field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan
from ..mpc.errors import InvariantError
from ..mpc.field import generator
from .config import ModelConfig, SSMConfig
from .layers import rms_norm
from .transformer import Tree

KEYS = ("in_proj", "conv_w", "conv_b", "x_bc", "x_dt", "dt_bias", "a_log",
        "d_skip", "out_proj")
# the published Jamba mixer's (``dt_rank > 0``)
PUBLISHED_KEYS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                  "dt_bias", "a_log", "d_skip", "out_proj", "dt_norm",
                  "b_norm", "c_norm")


class Mamba(Tree):
    """One Mamba block's weights: ``in_proj [D, 2 Di]``, ``conv_w [K, Di]``,
    ``conv_b [Di]``, ``x_bc [Di, 2 N]``, ``x_dt [Di, 1]``, ``dt_bias
    [Di]``, ``a_log [Di, N]``, ``d_skip [Di]`` and ``out_proj [Di, D]``; the
    published mixer has ``x_proj [Di, R + 2 N]``, ``dt_proj [R, Di]`` and
    its norms ``dt_norm [R]``, ``b_norm [N]`` and ``c_norm [N]`` in place
    of ``x_bc`` and ``x_dt``."""

    def __init__(self, tree):
        keys = PUBLISHED_KEYS if "x_proj" in tree else KEYS
        missing = sorted(set(keys) - set(tree))
        if missing:
            raise ValueError(f"a Mamba block needs {missing}")
        super().__init__({name: tree[name] for name in keys})


@dataclasses.dataclass(frozen=True)
class MambaConfig(SSMConfig):
    """:class:`SSMConfig` with the published mixer's switch: Δ at rank
    ``dt_rank`` with Jamba's RMS norms of Δ, B and C (0 keeps the rank-one
    ``x_dt``)."""

    dt_rank: int = 0


def dt_rank(s) -> int:
    """``s.dt_rank``, 0 for a plain ``SSMConfig``."""
    return getattr(s, "dt_rank", 0)


def d_inner(cfg: ModelConfig) -> int:
    return (cfg.ssm or SSMConfig()).expand * cfg.d_model


def init_ssm_params(key, cfg: ModelConfig, dtype, *, device) -> Mamba:
    """Random weights as the JAX ``init_ssm_params`` draws them (normal,
    scaled by ``fan_in ** -0.5``; conv bias 0, dt bias -4, ``a_log =
    log(1..N)``, skip 1), from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``; with ``dt_rank`` > 0 the published
    mixer's, drawn alike (``dt_bias`` as Mamba draws it)."""
    dev = torch.device(device)
    g = generator(key, dev)
    s = cfg.ssm or SSMConfig()
    d, di = cfg.d_model, d_inner(cfg)

    def mk(shape, scale_dim=d):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (x * scale_dim ** -0.5).to(dtype)

    def full(value, n=di):
        return torch.full((n,), value, dtype=dtype, device=dev)

    states = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=dev)
    if not dt_rank(s):
        return Mamba({
            "in_proj": mk((d, 2 * di)),
            "conv_w": mk((s.d_conv, di), s.d_conv),
            "conv_b": full(0.0),
            "x_bc": mk((di, 2 * s.d_state), di),
            "x_dt": mk((di, 1), di),
            "dt_bias": full(-4.0),
            "a_log": torch.log(states).expand(di, s.d_state).to(dtype).contiguous(),
            "d_skip": full(1.0),
            "out_proj": mk((di, d), di),
        })
    # the published mixer; dt_bias as Mamba draws it: the inverse softplus
    # of Δ log-uniform in [1e-3, 1e-1]
    r, n = s.dt_rank, s.d_state
    u = torch.rand(di, generator=g, device=dev, dtype=torch.float32)
    step = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                     + math.log(1e-3)).clamp(min=1e-4)
    return Mamba({
        "in_proj": mk((d, 2 * di)),
        "conv_w": mk((s.d_conv, di), s.d_conv),
        "conv_b": full(0.0),
        "x_proj": mk((di, r + 2 * n), di),
        "dt_proj": mk((r, di), r),
        "dt_bias": (step + torch.log(-torch.expm1(-step))).to(dtype),
        "a_log": torch.log(states).expand(di, n).to(dtype).contiguous(),
        "d_skip": full(1.0),
        "out_proj": mk((di, d), di),
        "dt_norm": full(1.0, r),
        "b_norm": full(1.0, n),
        "c_norm": full(1.0, n),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: [B, T, Di]; w: [K, Di]; state:
    [B, K-1, Di].  The terms are summed in the reference's order, in x's
    dtype."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return out, new_state


def _selective_scan_chunked(u, dt, a, b_t, c_t, chunk: int,
                            return_state: bool = False):
    """u: [B, T, Di]; dt: [B, T, Di]; a: [Di, N]; b_t, c_t: [B, T, N].

    Returns y [B, T, Di] (fp32) [, final state [B, Di, N] fp32]: the
    kernel on the card, the chunked associative scan in ``chunk`` windows
    on the CPU."""
    return selective_scan(u, dt, a, b_t, c_t, return_state=return_state,
                          chunk=chunk)


def _dt_b_c(cfg: ModelConfig, s: SSMConfig, xi: torch.Tensor, p):
    """Δ after its softplus, B and C from the conv's output ``xi``: at rank
    one (``x_bc``, ``x_dt``) or, with ``s.dt_rank``, the published mixer's
    ``x_proj`` split into Δ, B and C, each RMS-normed, and ``dt_proj``."""
    if not dt_rank(s):
        b_t, c_t = (xi @ p["x_bc"]).chunk(2, dim=-1)
        return F.softplus(xi @ p["x_dt"] + p["dt_bias"]), b_t, c_t
    n = s.d_state
    delta, b_t, c_t = (xi @ p["x_proj"]).split([s.dt_rank, n, n], dim=-1)
    delta = rms_norm(delta, p["dt_norm"], cfg.norm_eps)
    b_t = rms_norm(b_t, p["b_norm"], cfg.norm_eps)
    c_t = rms_norm(c_t, p["c_norm"], cfg.norm_eps)
    return F.softplus(delta @ p["dt_proj"] + p["dt_bias"]), b_t, c_t


def mamba_block(cfg: ModelConfig, x: torch.Tensor, p, *,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                decode: bool = False):
    """x: [B, T, D] -> (out, new_conv_state, new_ssm_state)."""
    s = cfg.ssm or SSMConfig()
    xz = x @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    xi = F.silu(xi)
    dt, b_t, c_t = _dt_b_c(cfg, s, xi, p)        # [B,T,Di], [B,T,N], [B,T,N]
    a = -torch.exp(p["a_log"].float())                        # [Di,N]

    if decode:
        # one step: h = exp(dt·a)·h + dt·b·u
        if ssm_state is None:
            raise InvariantError("ssm decode step reached without a "
                                 "recurrent state (prefill must seed it)")
        u1, dt1, b1, c1 = xi[:, 0], dt[:, 0], b_t[:, 0], c_t[:, 0]
        decay = torch.exp(dt1[..., None].float() * a[None])
        inc = (dt1 * u1)[..., None].float() * b1[:, None, :].float()
        h = ssm_state * decay + inc                           # [B,Di,N]
        y = torch.einsum("bdn,bn->bd", h, c1.float())[:, None]
        new_ssm = h
    else:
        y, new_ssm = _selective_scan_chunked(xi, dt, a, b_t, c_t, s.chunk,
                                             return_state=True)
    y = (y + (xi * p["d_skip"]).float()).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], new_conv, new_ssm


def init_states(cfg: ModelConfig, batch: int, *, device):
    """Zero (conv window ``[B, K-1, Di]`` in the model dtype, ssm state
    ``[B, Di, N]`` fp32) on ``device``."""
    s = cfg.ssm or SSMConfig()
    di = d_inner(cfg)
    conv = torch.zeros((batch, s.d_conv - 1, di), dtype=getattr(torch, cfg.dtype),
                       device=device)
    ssm = torch.zeros((batch, di, s.d_state), dtype=torch.float32, device=device)
    return conv, ssm

"""Mixture-of-Experts FFN: top-k routing with capacity dispatch, computed per
sequence chunk (the Switch/MaxText "dropping" formulation).

Port of ``repro/models/moe.py``.  Params: ``router [D, E]``;
``moe_w1``/``moe_w3 [E, D, F]``; ``moe_w2 [E, F, D]``.

The routing is the reference's, step for step: softmax over the router
logits in fp32, the top k experts per token (lower expert first among
equal probabilities, as ``jax.lax.top_k`` returns them: a stable
descending sort), gates renormalised over the k, and each ``(token, k)``
pick given a position in its expert's buffer in the flattened ``(token,
k)`` order of the chunk; picks at or past the capacity are dropped.

JAX materialises the one-hot ``[B, Tc, k, E, cap]`` (about 671 MB in bf16
per 2048-token chunk at E = 64, cap = 320) and contracts the dispatch and
combine tensors against the tokens.  The port builds the same routing by
index instead: each kept pick's token row is scattered into its expert's
buffer slot, and each token gathers its k slots back and weights them by
its gates.  :func:`dispatch_combine` builds the dense ``dispatch`` and
``combine`` tensors of the reference from the same indices (the tests
hold them equal).  The expert products are ``torch.einsum`` over the
buffers, as JAX computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..mpc.field import generator
from .config import MoEConfig


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _chunk(t: int, cfg: MoEConfig) -> int:
    """The largest divisor of ``t`` not above ``router_chunk``."""
    chunk = min(cfg.router_chunk, t)
    while t % chunk:
        chunk -= 1
    return chunk


class Routing(NamedTuple):
    """One chunk's routing: ``probs [B, Tc, E]`` (fp32), ``gate_vals``,
    ``gate_idx``, ``slot`` (each pick's position in its expert's buffer)
    and ``kept`` (``slot < cap``), all ``[B, Tc, k]``, and ``cap``."""

    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    cap: int


def route(xc: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The routing of one chunk ``xc [B, Tc, D]``."""
    b, tc, _ = xc.shape
    k, e = cfg.top_k, cfg.n_experts
    logits = xc @ router                                     # [B, Tc, E]
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = _capacity(tc, cfg)
    # each pick's position in its expert's buffer, in (token, k) order: a
    # running count per expert, laid out [B, E, Tc·k] so that the scan
    # runs along the innermost dimension (along dimension 1 of [B, Tc·k,
    # E], torch's scan walks 16384 steps per column: 3 ms a layer at
    # olmoe's prefill on an H100)
    flat = gate_idx.reshape(b, 1, tc * k)
    onehot = torch.zeros((b, e, tc * k), dtype=torch.int32, device=xc.device)
    onehot.scatter_(1, flat, 1)
    pos = torch.cumsum(onehot, dim=2).gather(1, flat).reshape(b, tc, k) - 1
    return Routing(probs, gate_vals, gate_idx, pos.long(), pos < cap, cap)


def dispatch_combine(r: Routing, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense ``dispatch`` and ``combine`` ``[B, Tc, E,
    cap]`` for a routing (``cap_onehot`` summed over k, and weighted by the
    gates in ``dtype``); for tests, the serving path never builds them."""
    b, tc, k = r.gate_idx.shape
    e = r.probs.shape[-1]
    flat = torch.where(r.kept, r.gate_idx * r.cap + r.slot,
                       torch.full_like(r.slot, e * r.cap))
    dispatch = torch.zeros((b, tc, e * r.cap + 1), dtype=dtype,
                           device=r.probs.device)
    combine = torch.zeros_like(dispatch)
    dispatch.scatter_(2, flat, torch.ones(flat.shape, dtype=dtype,
                                          device=flat.device))
    combine.scatter_(2, flat, r.gate_vals.to(dtype))
    shape = (b, tc, e, r.cap)
    return (dispatch[..., :-1].reshape(shape), combine[..., :-1].reshape(shape))


def _one_chunk(xc: torch.Tensor, params, cfg: MoEConfig):
    b, tc, d = xc.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(xc, params["router"], cfg)
    cap = r.cap
    # buffer slot of each pick, or a spare row past the buffers if dropped
    flat = torch.where(r.kept, r.gate_idx * cap + r.slot,
                       torch.full_like(r.slot, e * cap)).reshape(b, tc * k)
    rows = torch.arange(tc, device=xc.device).repeat_interleave(k)
    expert_in = torch.zeros((b, e * cap + 1, d), dtype=xc.dtype,
                            device=xc.device)
    # the slots of kept picks are distinct, so the scatter writes each once
    expert_in.scatter_(1, flat[..., None].expand(b, tc * k, d),
                       xc[:, rows])
    expert_in = expert_in[:, :-1].reshape(b, e, cap, d)
    h = (F.silu(torch.einsum("becd,edf->becf", expert_in, params["moe_w1"]))
         * torch.einsum("becd,edf->becf", expert_in, params["moe_w3"]))
    expert_out = torch.einsum("becf,efd->becd", h, params["moe_w2"])
    spare = torch.zeros((b, 1, d), dtype=expert_out.dtype,
                        device=expert_out.device)
    picked = torch.cat([expert_out.reshape(b, e * cap, d), spare], dim=1
                       ).gather(1, flat[..., None].expand(b, tc * k, d))
    gates = torch.where(r.kept, r.gate_vals, 0.0).to(xc.dtype)
    out = torch.einsum("btk,btkd->btd", gates, picked.reshape(b, tc, k, d))
    # aux loss: mean fraction routed vs mean router prob (Switch eq. 4)
    me = r.probs.mean(dim=(0, 1))                            # [E]
    ce = torch.zeros(e, dtype=torch.float32, device=xc.device).index_add_(
        0, r.gate_idx.reshape(-1),
        torch.ones(r.gate_idx.numel(), device=xc.device)) / r.gate_idx.numel()
    return out, e * torch.sum(me * ce)


def moe_ffn(x: torch.Tensor, params, cfg: MoEConfig):
    """``x: [B, T, D] -> ([B, T, D], aux)``: the aux load-balance loss is a
    0-d fp32 tensor, averaged over the chunks."""
    b, t, d = x.shape
    chunk = _chunk(t, cfg)
    outs, auxs = [], []
    for c0 in range(0, t, chunk):
        out, aux = _one_chunk(x[:, c0:c0 + chunk], params, cfg)
        outs.append(out)
        auxs.append(aux)
    if len(outs) == 1:
        return outs[0], auxs[0]
    return torch.cat(outs, dim=1), torch.stack(auxs).mean()


def init_moe_params(key, d_model: int, cfg: MoEConfig, dtype, *,
                    device) -> Dict[str, torch.Tensor]:
    """Random expert weights as the JAX ``init_moe_params`` draws them
    (normal, scaled by ``fan_in ** -0.5``), from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``."""
    dev = torch.device(device)
    g = generator(key, dev)
    e, f = cfg.n_experts, cfg.d_ff_expert

    def mk(shape, fan_in):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (x * fan_in ** -0.5).to(dtype)

    return {"router": mk((d_model, e), d_model),
            "moe_w1": mk((e, d_model, f), d_model),
            "moe_w3": mk((e, d_model, f), d_model),
            "moe_w2": mk((e, f, d_model), f)}

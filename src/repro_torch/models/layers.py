"""Shared transformer building blocks: RMSNorm, RoPE, GQA attention
(direct / flash-kernel / decode-with-cache), SwiGLU MLP.

Port of ``repro/models/layers.py``.  Layers take and return tensors in the
JAX package's ``[B, T, H, D]`` layout, so each function compares with its
counterpart on the same inputs.  The reference's ``shard(...)``
annotations are left out: the port has no SPMD partitioner, and the
multi-rank trainer lays out the weights and splits the batch itself
(:mod:`repro_torch.parallel.fsdp`).

Prefill and training attention (:func:`attention_chunked`) runs the
hand-written flash kernel on the card, with its hand-written backward
under autograd; decode attention stays plain torch, as the JAX package
computes it in XLA and not in a Pallas kernel.  :func:`remat` is the
port's ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention

NEG_INF = -1e30


def remat(fn, *args):
    """``fn(*args)`` with its activations dropped and recomputed in the
    backward pass, as ``jax.checkpoint(fn)(*args)``; a plain call when
    autograd is not recording.  Non-reentrant, so the weights ``fn``
    reaches through its closure or a module argument get their
    gradients."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] (absolute)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # [D/2]
    ang = positions[..., None].float() * freqs                     # [B, T, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --
def _gqa_repeat(k: torch.Tensor, group: int) -> torch.Tensor:
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            visible: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D))`` over the visible keys, then ``@ v``;
    logits and softmax in fp32, probabilities back in q's dtype.  q:
    ``[B, T, Hq, D]``; k, v: ``[B, S, Hkv, D]``; visible broadcasts to
    ``[B, Hq, T, S]``.  Operands of two dtypes multiply in the promoted
    one, as JAX's einsums do, so the result takes ``promote(q, v)``."""
    d = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    kr, vr = _gqa_repeat(k, group), _gqa_repeat(v, group)
    qk = torch.promote_types(q.dtype, k.dtype)
    logits = (torch.einsum("bthd,bshd->bhts", q.to(qk), kr.to(qk))
              / q.new_tensor(d).sqrt())
    logits = logits.float().masked_fill(~visible, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    pv = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.to(pv), vr.to(pv))


def attention_direct(q, k, v, *, causal: bool, q_offset: int = 0):
    """Materialized-logits attention (small T or decode)."""
    tq, s = q.shape[1], k.shape[1]
    visible = torch.ones((tq, s), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        visible = q_pos >= torch.arange(s, device=q.device)[None, :]
    return _attend(q, k, v, visible)


def attention_chunked(q, k, v, *, causal: bool):
    """Prefill and training attention: the flash kernel on the card, its
    plain version on the CPU; under autograd the backward is the flash
    backward kernel (its plain version on the CPU).  The reference's XLA
    online-softmax scan (``q_chunk`` / ``kv_chunk`` tiles) is the Pallas
    kernel's twin, and training differentiates it with XLA's autodiff;
    here the kernels tile themselves.

    Operands of two dtypes (whisper's bf16 queries against keys and values
    from fp32 frames) run the kernel instance of the promoted type, and
    the result comes back in q's dtype, as the reference's ``out.astype(
    qblk.dtype)``; k and v are never rounded down to q's dtype.  The
    reference also rounds P to q's dtype before ``P V``; the promoted-type
    kernel keeps P in fp32, inside the bf16 result's own rounding."""
    if q.dtype == k.dtype == v.dtype:
        return flash_attention(q, k, v, causal=causal)
    dt = torch.promote_types(q.dtype, torch.promote_types(k.dtype, v.dtype))
    return flash_attention(q.to(dt), k.to(dt), v.to(dt),
                           causal=causal).to(q.dtype)


# --------------------------------------------------------------- KV cache --
@dataclasses.dataclass
class KVCache:
    """Static-shape cache: ``[L?, B, S_max, Hkv, D]`` + the filled length."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def decode_attention(q, cache: KVCache, k_new, v_new, *, pos: int):
    """One-token decode: write slot ``pos``, attend over the valid prefix.

    q: [B, 1, Hq, D]; k_new/v_new: [B, 1, Hkv, D]; pos: int.  The port
    writes ``cache.k``/``cache.v`` in place (JAX returns updated copies);
    the returned cache shares their storage.
    """
    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    s = cache.k.shape[1]
    visible = torch.arange(s, device=q.device) <= pos
    out = _attend(q, cache.k, cache.v, visible)
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


# ---------------------------------------------------------- paged KV cache --
@dataclasses.dataclass
class PagedKVCache:
    """Block-pooled KV storage: fixed-size blocks shared by every lane of a
    serving batch, indexed through per-lane block tables.

    ``k``/``v``: [L?, n_blocks, block_size, Hkv, D].  Which blocks a lane
    owns lives outside (the scheduler's
    :class:`~repro_torch.serve.paging.BlockAllocator`).  Block 0 is the
    null block: idle lanes park their writes there.
    """
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def init(n_blocks: int, block_size: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, leading: tuple = (), *, device) -> "PagedKVCache":
        shape = (*leading, n_blocks, block_size, n_kv, head_dim)
        return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device))


def paged_decode_attention(q, k_pool, v_pool, tables, k_new, v_new, *, pos):
    """One-token decode over a paged pool, the block-table twin of
    :func:`decode_attention`.

    q: [B, 1, Hq, D]; k_pool/v_pool: [NB, BS, Hkv, D] (one layer's pool);
    tables: [B, MB] int block ids; k_new/v_new: [B, 1, Hkv, D]; pos: [B]
    int, each lane's own write/attend position.  Positions past ``pos`` are
    masked to exact softmax zeros, so recycled blocks and pool padding
    never perturb a lane.  The port writes the pools in place (JAX returns
    updated copies); returns ``(out [B,1,Hq,D], k_pool, v_pool)``.
    """
    b = q.shape[0]
    bs, hkv, d = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    lane = torch.arange(b, device=q.device)
    blk = tables[lane, pos // bs]                        # [B]
    off = pos % bs
    k_pool[blk, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[:, 0].to(v_pool.dtype)
    k = k_pool[tables].reshape(b, -1, hkv, d)            # [B, MB*BS, Hkv, D]
    v = v_pool[tables].reshape(b, -1, hkv, d)
    visible = (torch.arange(k.shape[1], device=q.device)[None, :]
               <= pos[:, None])[:, None, None, :]        # [B, 1, 1, S]
    return _attend(q, k, v, visible), k_pool, v_pool


# ------------------------------------------------------------------ MLPs --
def swiglu(x, w1, w3, w2):
    """SwiGLU FFN; w1, w3: [D, F], w2: [F, D]."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gqa_project(x, p, cfg, *, positions=None):
    """QKV projection + RoPE; returns q, k, v in [B, T, H, D] layout.
    ``p`` holds ``w_q``, ``w_k``, ``w_v`` (a layer module or a mapping)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["w_q"]).reshape(b, t, cfg.n_heads, hd)
    k = (x @ p["w_k"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(b, t, cfg.n_kv_heads, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v

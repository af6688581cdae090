"""The yardstick of the hybrid (Jamba) training cell: the work of the
selective scan and the flash attention kernels, forward and backward, and
of one training step.

A frozen copy, kept with the benchmark so that no change to the program
moves it: ``scan_work``, ``scan_bwd_work``, ``attn_work`` and
``bwd_work`` follow ``repro_torch/kernels/work.py`` as they stood when
the cell was made, taking shapes in place of tensors.  The rates are
``work.py``'s (NVIDIA H100 SXM data sheet, dense), with the fp32 rate
outside the tensor cores for the scans.

Bytes count each input read once and each output written once;
operations count the work the inputs need, at the fastest peak that could
do them in the operands' dtype.
"""
from __future__ import annotations

from portbench.harness.work import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, bound_s

FP32_FLOPS_PER_S = 67e12

__all__ = ["BF16_FLOPS_PER_S", "FP32_FLOPS_PER_S", "HBM_BYTES_PER_S",
           "attn_work", "bound_s", "bwd_work", "causal_pairs",
           "jamba2_matmul_params", "jamba2_step_flops", "scan_bwd_work",
           "scan_work"]


def causal_pairs(t: int, s: int, causal: bool = True,
                 q_offset: int = 0) -> int:
    """Visible (row, key) pairs of a ``[T, S]`` mask: row i sees
    ``min(S, q_offset + i + 1)`` keys when causal (0 when negative)."""
    if not causal:
        return t * s
    lo = min(t, max(0, -q_offset))             # first row that sees a key
    full = min(t, max(lo, s - q_offset - 1))   # first row that sees all S
    first, rows = q_offset + lo + 1, full - lo
    return rows * (2 * first + rows - 1) // 2 + (t - full) * s


def _peak(elem_bytes: int) -> float:
    return BF16_FLOPS_PER_S if elem_bytes == 2 else FP32_FLOPS_PER_S


def attn_work(b, t, s, hq, hkv, d, elem_bytes, causal=True, q_offset=0):
    """(bytes, flops, peak rate) of one attention call, q ``[b, t, hq,
    d]`` against k, v ``[b, s, hkv, d]``: q, k, v read once and o written
    once; 4 d flops (q k and p v) per visible (row, key) pair and head."""
    pairs = causal_pairs(t, s, causal, q_offset)
    nbytes = elem_bytes * (2 * b * t * hq * d + 2 * b * s * hkv * d)
    return nbytes, 4 * d * hq * b * pairs, _peak(elem_bytes)


def bwd_work(b, t, s, hq, hkv, d, elem_bytes, causal=True, q_offset=0):
    """(bytes, flops, peak rate) of one attention backward: q, k, v, o, dO
    and lse read once, dq, dk and dv written once; the five products (S
    recomputed, dP, dV, dQ, dK) take 10 d flops per visible pair and
    head."""
    pairs = causal_pairs(t, s, causal, q_offset)
    nbytes = (elem_bytes * (6 * b * t * hq * d + 4 * b * s * hkv * d)
              + 4 * b * hq * t)
    return nbytes, 10 * d * hq * b * pairs, _peak(elem_bytes)


def scan_work(b, t, di, n, elem_bytes):
    """(bytes, fp32 operations) of one selective scan: u, dt, b and c read
    once in their dtype and a in fp32, y and the final state written once
    in fp32; about 6 operations per (b, t, d, n)."""
    nbytes = (elem_bytes * (2 * b * t * di + 2 * b * t * n) + 4 * di * n
              + 4 * b * t * di + 4 * b * di * n)
    return nbytes, 6 * b * t * di * n


def scan_bwd_work(b, t, di, n, elem_bytes):
    """(bytes, fp32 operations) of one scan backward: u, dt read and du,
    ddt written in their dtype, dy and the checkpoints (h every 32 steps)
    read in fp32, b, c read and db, dc written, a read and da written;
    about 20 fp32 operations per (b, t, d, n)."""
    nbytes = (4 * b * t * di * elem_bytes + 4 * b * t * di
              + 4 * b * (-(-t // 32)) * di * n + 4 * b * t * n * elem_bytes
              + 8 * di * n)
    return nbytes, 20 * b * t * di * n


def jamba2_matmul_params(cfg: dict) -> int:
    """Weights of a dense Jamba used as matmul operands, by the
    configuration's keys: per Mamba layer ``in_proj``, ``x_proj``,
    ``dt_proj`` and ``out_proj``, per attention layer q, k, v and o, per
    layer the SwiGLU's three, and the tied head once (the embedding's
    gather is a lookup)."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    di = cfg["mamba_expand"] * d
    n, r = cfg["mamba_d_state"], cfg["mamba_dt_rank"]
    kv = cfg["num_key_value_heads"] * d // cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    attn = sum(1 for l in range(layers)
               if l % cfg["attn_layer_period"] == cfg["attn_layer_offset"])
    mamba = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return ((layers - attn) * mamba + attn * (2 * d * d + 2 * d * kv)
            + layers * 3 * d * ff + cfg["vocab_size"] * d)


def jamba2_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """FLOPs of one training step of ``rows`` sequences of ``seq`` tokens:
    6 per matmul weight and token, plus the causal attention's 12 hd H per
    visible (row, key) pair (4 forward, 8 backward) in each attention
    layer.  Remat's recomputation and the scans are not counted."""
    heads = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    attn = sum(1 for l in range(cfg["num_hidden_layers"])
               if l % cfg["attn_layer_period"] == cfg["attn_layer_offset"])
    pairs = causal_pairs(seq, seq)
    return (6 * jamba2_matmul_params(cfg) * rows * seq
            + 12 * hd * heads * pairs * rows * attn)

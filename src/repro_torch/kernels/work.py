"""What each kernel must move and compute, and the tally its meta branch feeds.

Every kernel wrapper of this package has three branches: the plain
version on a CPU tensor, the kernel on a CUDA tensor, and on a ``meta``
tensor (a shape with no storage) outputs of the right shapes and dtypes
whose work is added to the active tallies and nothing else: no launch, no
count, and never the plain version (``rwkv6_plain``'s loop over T steps
would take hours at T = 32768).  :mod:`repro_torch.launch.hlo_analysis`
opens a tally over a cell traced on meta tensors; the dry-run reads it.

The work formulas are the ones ``chip_smoke.py`` bounds each kernel's
time with: ``(bytes, operations)`` (attention's also its peak rate),
where bytes are each input read once and each output written once, and
operations are counted for the call's own mask and shapes.  The rates are
the NVIDIA H100 SXM data sheet's (dense).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

# NVIDIA H100 SXM data sheet (dense): HBM rate, int8 and bf16 tensor-core
# peaks, TF32, fp32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
HBM_BYTES = 80e9

# the WKV-6 kernels' head size (K = V)
WKV_HEAD = 64


def limbs(p):
    """8-bit limbs per field element under the int8 tensor-core schedule
    (``csrc/modmatmul_tc.cu``): 4 for both primes, 16 limb products."""
    return -(-p.bit_length() // 8)


def mm_work(w, m, k, n, p):
    """(bytes, int8 operations) of ``W`` products ``[M, K] @ [K, N]`` mod p
    on int64 elements."""
    return 8 * w * (m * k + k * n + m * n), 2 * w * m * k * n * limbs(p) ** 2


def pe_work(n, k, c, p):
    """(bytes, int8 operations) of one ``polyeval`` lane: ``[N, K] @ [K, C]``
    mod p on int64 elements."""
    return 8 * (n * k + k * c + n * c), 2 * n * k * c * limbs(p) ** 2


def fold_work(n, elem_bytes):
    """(bytes, 32-bit integer ops) of one ``ring_fold`` of n elements: two
    inputs read and the output written once; an add and a compare-subtract
    per element."""
    return 3 * n * elem_bytes, 2 * n


def _pairs(t, s, causal, q_offset):
    """Visible (row, key) pairs of a ``[T, S]`` mask: the causal sum in
    closed form, row i seeing ``min(S, q_offset + i + 1)`` keys (0 when
    that is negative)."""
    if not causal:
        return t * s
    # rows with 0 < q_offset + i + 1 < S see q_offset + i + 1 keys, later
    # rows see S
    lo = min(t, max(0, -q_offset))             # first row that sees a key
    full = min(t, max(lo, s - q_offset - 1))   # first row that sees all S
    first, rows = q_offset + lo + 1, full - lo
    return rows * (2 * first + rows - 1) // 2 + (t - full) * s


def attn_work(q, k, causal, q_offset):
    """(bytes, flops, peak rate) of one attention call: q, k, v read once
    and o written once; 4 D flops (q k and p v) per visible (row, key) pair
    and head, counted for this call's mask."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    pairs = _pairs(t, s, causal, q_offset)
    nbytes = q.element_size() * (2 * b * t * hq * d + 2 * b * s * hkv * d)
    peak = BF16_OPS_PER_S if q.element_size() == 2 else FP32_OPS_PER_S
    return nbytes, 4 * d * hq * b * pairs, peak


def bwd_work(q, k, causal, q_offset):
    """(bytes, flops, peak rate) of one attention backward: q, k, v, o, dO
    and lse read once, dq, dk and dv written once; the five products (S =
    q k^T recomputed, dP = dO v^T, dV = P^T dO, dQ = dS k, dK = dS^T q)
    take 10 D flops per visible (row, key) pair and head, counted for this
    call's mask."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    pairs = _pairs(t, s, causal, q_offset)
    el = q.element_size()
    nbytes = el * (6 * b * t * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * t
    peak = BF16_OPS_PER_S if el == 2 else FP32_OPS_PER_S
    return nbytes, 10 * d * hq * b * pairs, peak


def wkv_work(b, t, h, elem_bytes, state_in, d=WKV_HEAD):
    """(bytes, sequential fp32 flops) of one WKV call at K = V = d: r, k,
    v, w and u read once (and state0 when given), out and the final state
    written once in fp32; about 7 K V flops per (b, t, h) in the sequential
    form."""
    kv = d * d
    nbytes = (4 * b * t * h * d * elem_bytes + 4 * h * d + 4 * b * t * h * d
              + 4 * b * h * kv * (2 if state_in else 1))
    return nbytes, 7 * kv * b * t * h


def wkv_bwd_work(b, t, h, elem_bytes, d=WKV_HEAD):
    """(bytes, fp32 flops) of one WKV backward at K = V = d: r, k, v, w
    read and dr, dk, dv, dw written once in their dtype, dout read in fp32,
    u read and du written; 10 K V flops per (b, t, h): S's update and
    S_{t-1} dout_t, G's update, G_t v_t and k_t G_t."""
    kv = d * d
    nbytes = 8 * b * t * h * d * elem_bytes + 4 * b * t * h * d + 8 * h * d
    return nbytes, 10 * kv * b * t * h


def scan_work(b, t, di, n, elem_bytes):
    """(bytes, fp32 operations) of one selective scan: u, dt, b and c read
    once in their dtype and a in fp32, y and the final state written once
    in fp32; about 6 operations per (b, t, d, n): dt a, the exponential,
    the update's fma (2), h c and its share of the sum over n."""
    nbytes = (elem_bytes * (2 * b * t * di + 2 * b * t * n) + 4 * di * n
              + 4 * b * t * di + 4 * b * di * n)
    return nbytes, 6 * b * t * di * n


def scan_bwd_work(b, t, di, n, elem_bytes):
    """(bytes, fp32 operations) of one scan backward: u, dt read and du,
    ddt written in their dtype, dy and the checkpoints read in fp32, b, c
    read and db, dc written, a read and da written; about 20 fp32
    operations per (b, t, d, n) (G's update, the four gradients' terms)."""
    nbytes = (4 * b * t * di * elem_bytes + 4 * b * t * di
              + 4 * b * (-(-t // 32)) * di * n + 4 * b * t * n * elem_bytes
              + 8 * di * n)
    return nbytes, 20 * b * t * di * n


# ------------------------------------------------------------- the tally --
_TALLIES: List[Callable[[str, int, int], None]] = []


def record(kernel: str, nbytes, ops) -> None:
    """Add one meta-branch call's work to every open tally."""
    for add in _TALLIES:
        add(kernel, int(nbytes), int(ops))


@contextlib.contextmanager
def tallying(add: Callable[[str, int, int], None]):
    """Send the meta branches' work to ``add(kernel, bytes, ops)`` inside
    the block."""
    _TALLIES.append(add)
    try:
        yield
    finally:
        _TALLIES.remove(add)

"""The yardstick: peaks of one H100 and the work each measured kernel needs.

A frozen copy, kept with the benchmark so that no change to the program
moves it.  The formulas follow ``repro_torch/kernels/work.py`` and
``chip_smoke.py``'s ``bound`` as they stood when the benchmark was made,
with one change: a residue product mod p counts ``LIMB_PRODUCTS`` = 9
int8 products (Karatsuba's split of four 8-bit limbs), not the 16 of the
present tensor-core schedule, so that no design with fewer limb products
can read over 100 % of its roofline, and a residue counts the 4 bytes
(int32) that p < 2^31 needs, not the 8 of the present kernels' int64
elements, so that a design that stores residues as int32 cannot either.

Bytes count each input read once and each output written once.
Operations count the work the inputs need, at the fastest peak that could
do them in the operands' dtype.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12

# int8 products per residue product: four 8-bit limbs split twice by
# Karatsuba (3 x 3); the present kernel does all 4 x 4 = 16
LIMB_PRODUCTS = 9
# bytes of one field element at the width p needs: p < 2^31 fits int32
# (the present kernels hold int64, twice this)
ELEMENT_BYTES = 4


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory rate and operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def modmatmul_work(w: int, m: int, k: int, n: int,
                   limb_products: int = LIMB_PRODUCTS):
    """(bytes, int8 operations) of ``w`` products ``[m, k] @ [k, n]`` mod p
    on int32 elements: a multiply-add is 2 operations per limb product."""
    nbytes = ELEMENT_BYTES * w * (m * k + k * n + m * n)
    return nbytes, 2 * w * m * k * n * limb_products


def polyeval_work(n: int, k: int, c: int, limb_products: int = LIMB_PRODUCTS):
    """(bytes, int8 operations) of one table product ``[n, k] @ [k, c]`` mod
    p on int32 elements, the table, the operand and the result each moved
    once."""
    nbytes = ELEMENT_BYTES * (n * k + k * c + n * c)
    return nbytes, 2 * n * k * c * limb_products


def block_shapes(s: int, t: int, z: int, n_workers: int, m: int) -> dict:
    """The products one coded ``m x m`` block needs under AGE-CMPC with
    ``s x t`` partitions and collusion bound ``z`` over ``n_workers``: the
    two phase-1 share evaluations, the workers' block products, the
    phase-2 exchange (G-mix of the N products and the aggregate mask) and
    the decode over the ``t^2 + z`` survivors' I-points."""
    mt, ms = m // t, m // s
    return {
        "worker_compute": (n_workers, mt, ms, mt),
        "tables": [
            (n_workers, s * t + z, mt * ms),          # encode A
            (n_workers, s * t + z, ms * mt),          # encode B
            (n_workers, n_workers + z, mt * mt),      # exchange
            (t * t, t * t + z, mt * mt),              # decode
        ],
    }


def modmatmul_block_bound_s(s, t, z, n_workers, m,
                            limb_products: int = LIMB_PRODUCTS) -> float:
    """Least time of one block's worker products."""
    w, mm, k, n = block_shapes(s, t, z, n_workers, m)["worker_compute"]
    nbytes, ops = modmatmul_work(w, mm, k, n, limb_products)
    return bound_s(nbytes, ops, INT8_OPS_PER_S)


def polyeval_block_bound_s(s, t, z, n_workers, m,
                           limb_products: int = LIMB_PRODUCTS) -> float:
    """Least time of one block's four table products, each bounded alone."""
    return sum(bound_s(*polyeval_work(n, k, c, limb_products), INT8_OPS_PER_S)
               for n, k, c in block_shapes(s, t, z, n_workers, m)["tables"])


def computation_per_worker(r: int, k: int, c: int, s: int, t: int, z: int,
                           n_workers: int) -> float:
    """The paper's eq. (15) at a user's ``[r, k] x [k, c]`` product: the
    worker's share product ``r k c / (s t^2)`` (``m^3 / (s t^2)``), its
    ``r c`` output (``m^2``) and its part of the exchange ``N (t^2 + z -
    1) r c / t^2``, in multiply-adds."""
    return (r * k * c / (s * t * t) + r * c
            + n_workers * (t * t + z - 1) * r * c / (t * t))


def private_call_ops(r, k, c, s, t, z, n_workers,
                     limb_products: int = LIMB_PRODUCTS) -> float:
    """int8 operations of one private product: eq. (15) over all N
    workers, 2 operations a multiply-add, ``limb_products`` per residue
    product."""
    return (n_workers * computation_per_worker(r, k, c, s, t, z, n_workers)
            * 2 * limb_products)


def wkv_work(b: int, t: int, h: int, elem_bytes: int, d: int = 64):
    """(bytes, flops) of one WKV-6 forward at K = V = d from a zero state:
    r, k, v, w read once in their dtype and u in fp32, the fp32 output and
    final state written once; 7 K V flops per (b, t, h) in the sequential
    form."""
    kv = d * d
    nbytes = (4 * b * t * h * d * elem_bytes + 4 * h * d + 4 * b * t * h * d
              + 4 * b * h * kv)
    return nbytes, 7 * kv * b * t * h


def wkv_bwd_work(b: int, t: int, h: int, elem_bytes: int, d: int = 64):
    """(bytes, flops) of one WKV-6 backward at K = V = d: r, k, v, w read
    and dr, dk, dv, dw written in their dtype, dout read in fp32, u read
    and du written; 10 K V flops per (b, t, h)."""
    kv = d * d
    nbytes = 8 * b * t * h * d * elem_bytes + 4 * b * t * h * d + 8 * h * d
    return nbytes, 10 * kv * b * t * h


def peak_flops(elem_bytes: int) -> float:
    """The fastest rate for float work on operands of this size: bf16 (and
    fp16) tensor cores for 2 bytes, TF32 for 4."""
    return BF16_FLOPS_PER_S if elem_bytes <= 2 else TF32_FLOPS_PER_S


def rwkv6_matmul_params(d: int, d_ff: int, vocab: int, n_layers: int,
                        lora: int) -> int:
    """Weights of rwkv6 used as matmul operands, the head included and the
    embedding (a lookup) left out: per layer r, k, v, g, o (5 d^2), the
    decay's low-rank pair (2 d lora) and the channel mix (2 d d_ff + d^2)."""
    per_layer = 5 * d * d + 2 * d * lora + 2 * d * d_ff + d * d
    return n_layers * per_layer + d * vocab


def rwkv6_step_flops(d, d_ff, vocab, n_layers, lora, tokens,
                     head: int = 64) -> float:
    """FLOPs of one training step: 6 per matmul weight and token, plus the
    WKV recurrence forward (7 K V) and backward (10 K V) per token, head
    and layer.  Remat's recomputation is not counted."""
    heads = d // head
    wkv = 17 * head * head * heads * n_layers * tokens
    return 6 * rwkv6_matmul_params(d, d_ff, vocab, n_layers, lora) * tokens + wkv

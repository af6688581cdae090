#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (``nvidia-smi``); exits non-zero
   when there is no card.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, all at once) and prints the
   build time and ``-Xptxas -v``'s registers, shared memory and spills,
   and any "Potential Performance Loss" ptxas reports (serialized wgmma).
3. Holds every mod-p kernel against its plain version on the card
   (``torch.equal``) for both primes, at the main path's shapes, ragged
   shapes and the all-(p-1) corner at the edges the overflow proof
   certifies (``repro_torch.analysis.overflow``): K = 2
   ``certified_window(p)`` + 1 for the uint64 accumulators (``cuda_core``
   with one block a tile and with K split, ``skinny``, ``polyeval``) and K
   = 2 ``certified_k_run()`` + 1 for the tensor-core instance's s32 runs,
   each equal to the closed form; and times both with CUDA events.
   ``modmatmul_batched`` has two instances (``choose_instance``): the
   tensor-core one serves the main shape, and the CUDA-core one is held
   and timed beside it in the same run through the module's private
   launcher; cuBLAS's int8 rate on the same 16 limb products
   (``torch._int_mm``, which the port never calls) is printed as a
   yardstick.  ``polyeval`` is held and timed at the four launches of one
   main-path block in the forms the stages pass (encode twice; the exchange
   as two sources stacked; decode through a device index of survivor
   rows), each beside its bytes bound, and held on ragged shapes, odd C,
   rows that are not 16-byte aligned and the all-(p-1) corner at the
   window's edge.
   The remote path's own shapes are held and timed too: a worker's W = 1
   product ``[1,1024,1024]^2`` (the tensor-core instance, read from the
   instance counters), its G row ``[17,1] @ [1,2^20]`` and the dealer's
   mask term ``[17,2] @ [2,2^20]``; and the sharded path's: a shard's
   W = 5 product ``[5,1024,1024]^2`` (tensor cores, from the counters), its
   encode ``[5,6] @ [6,2^20]``, its exchange ``[20,15] @ ([5,2^20],
   [10,2^20])``, and the ``ring_fold`` kernel on a shard's int32 and int64
   ``[5,2^20]`` chunk, an odd C and the all-(p-1) corner (where an int32
   sum overflows for Mersenne-31).
4. Holds the flash-attention kernel against its plain version at the
   serve path's prefill shapes (llama3.2-1b: Hq 32, Hkv 8, D 64, bf16,
   T = 2048 and 512), a ragged T, T != S with ``q_offset``, non-causal and
   fp32, within ``flash_attention.agreement``'s limits (2e-5 in fp32; in
   bf16 two ULP of each element and 2^-8 in relative Frobenius norm), and
   shows that two planted faults fail that check; times the kernel, the
   plain version and ``scaled_dot_product_attention`` (the library
   yardstick, which the port never calls).  bf16 with aligned rows takes
   the wgmma instance; the ``mma.sync`` instance serves the unaligned
   views and is held and timed beside it at the prefill shapes.
5. Runs the MPC main path: a full-width lm_head projection
   ``[1, 2048] x [2048, 128256]`` (llama3.2-1b's hidden size and
   vocabulary) through ``connect(MPCSpec(s=2, t=2, z=2)).matmul`` on the
   card; checks it exact in the field, from all 17 workers and from only
   t^2+z = 6 of them, and on floats equal to the float64 product of the
   operands as the field encodes them; checks from the launch counters
   that every product ran in the kernels, all 63 worker products in the
   tensor-core instance and 4 polyeval launches per block (252).
   A ``torch.profiler`` table of one more call shows where its device time
   goes, and that no torch elementwise pass runs over a block's
   ``[17, 1024^2]`` I-points (the exchange folds inside ``polyeval``).
6. Drives the ``tags`` stage (the W = 1 ``modmatmul``, its ``skinny``
   instance) on the main path's plan.
6b. The batched engine and Byzantine decode on the card.  Holds the
   ``skinny`` instance against its plain version (``torch.equal``) at the
   MAC tags' ``[17,2^20]@[2^20,1]`` and an 8-lane wave's
   ``[8,17,2^20]@[8,2^20,1]``, both primes, a ragged (odd) K and the
   all-(p-1) corner, timed beside the plain version, the earlier
   ``cuda_core`` instance and the bytes bound.  Then serves the full-width
   lm_head (p = 2^26-5, encoded) through three batched sessions: (a) the
   default policy (width 1, the fused path), (b) ``adversaries=1`` with
   8-lane waves (``max_batch=8, wave_scalars=None``), (c) the same with a
   ``FaultInjector`` that tampers one slot in one round and corrupts one
   tag in another.  Each must equal ``(A @ B) mod p``; per wave the
   launches are 3 ``polyeval`` + 1 ``modmatmul_batched`` (tensor cores)
   for the front, 2 ``skinny`` for the tags and 1 ``polyeval`` per
   survivor pattern; (c) shows its corrections, evictions and the
   injector's log equal to the schedule.  Prints wall times beside the
   local backend's, peak memory and a profiler table of one verified
   call.  Last, ``sess.fail`` takes (a)'s pool below N, the engine
   re-tunes through ``ElasticPool.retune`` -> ``autotune.retune_spec``, and
   the next call is still exact.
6c. The remote phase: the remote backend (``backend="remote"``, the socket
   transport) on the card at the main path's block, m = 2048 and N = 17,
   on the lm_head's first 8192 columns (4 blocks, more than the driver's
   window of 2).  (a) Thread mode, pipelined over the 4 blocks and then
   barriered over 2 under ``torch.profiler``: exact, equal to the local
   backend; per block each worker launches one W = 1
   ``modmatmul_batched`` (tensor cores) and one K = 1 ``polyeval`` (its G
   row) and the dealer 4 ``polyeval`` (encode twice, the mask term,
   decode); prints wall time per call and, per block, the dealer's encode
   and decode, its host time, the workers' compute and the wire time from
   a ``PhaseRecorder``, the payload bytes, and the barriered call's
   device busy share.  (b) Chaos, 2 blocks each: a worker dying after its
   shares arrive (a phase-2 loss) is recovered exactly through the
   engine's replan, one dying after its I point is absorbed by the
   survivor mask.  (c) Process mode: 17 spawned processes on the card, 2
   blocks, exact and equal to (a); prints the time from spawn to every
   worker ready, and each process's launch counters, which it reports as
   it exits, must show its 2 tensor-core products and 2 G rows on this
   card.
   (d) ``ProtocolStages.timed`` on the lm_head plan, ``sim.calibrate`` on
   (a)'s per-device samples and ``sim.divergence.gate()`` at 1000 devices
   (which must be ok), with no JAX installed.  Prints the phase's wall
   time and a ``{"remote": ...}`` line.
6d. The sharded phase: the full-width lm_head through
   ``backend="sharded"`` on ``make_mesh((4,), ("model",), devices=
   ["cuda:0"] * 4)`` (N_pad = 20, 5 workers a shard), both primes, the
   int64 wire and the int32 wire with ``prg_masks``: ``Y`` equal, integer
   for integer, to the local backend's; per block 13 ``polyeval`` (3 a
   shard and the decode), 4 ``modmatmul_batched`` (all tensor cores) and,
   on the int32 wire, 12 ``ring_fold``, read from the counters; ms per
   call beside the local backend's; one float call equal to the float64
   product of the fixed-point operands.
7. Serves llama3.2-1b at full width and depth (16 layers, bf16 weights
   drawn from ``--seed``): ``Engine`` on the card, a scheduler with 4
   lanes and block size 16, 8 requests of 128 to 2048 prompt tokens.
   Checks every request's tokens, mid-stream admission, 16 flash launches
   per prefill (all in the wgmma instance, none writing the training
   forward's lse) and no plain attention, and
   that a second run gives the same tokens; holds the kernel against its
   plain version on layer 0's real q, k, v; prints prefill times (one
   ``prefill`` call per prompt length), the scheduler's decode step times
   and peak memory.
8. Runs the served model's lm_head privately: the final hidden state of
   the first 2048-token request times the tied head ``embed.T`` through
   the MPC session, equal to the float64 product of the fixed-point
   operands, with the same greedy token.
9. Serves rwkv6-1.6b at full width and depth (24 layers, d 2048, bf16
   weights drawn from ``--seed``, 1.58 B parameters).  First holds the
   WKV-6 kernel against its plain version within ``rwkv6.agreement``'s
   limits (1e-4 of each element's |ref| plus its row's rms, 1e-5 in
   relative Frobenius norm; output and final state) at ``[4,2048,32,64]``
   and ``[1,1000,32,64]``, bf16 and fp32, w around -6 and 0, with and
   without a start state; shows that three planted faults fail that check
   and times the kernel and the plain version.  Then runs
   ``Engine.generate`` on ``[4, 2048]`` (32 new tokens) and ``[1, 1000]``
   (16), twice, weights drawn anew: 24 kernel launches per prefill, no
   plain WKV call, the same tokens both times.  Prints prefill and decode
   times against the weight-read floor, peak memory and the device busy
   share; holds the kernel on layer 0's real operands; and checks in fp32
   that decoding one step from a prefill of T - 1 tokens gives the logits
   and greedy tokens of a prefill of T, which a zeroed WKV state fails.
10. Serves olmoe-1b-7b at its published width and depth (16 layers, d
   2048, 16 heads of 128, 64 experts top-8 of width 1024, vocab 50304,
   bf16 weights drawn from ``--seed``, 6.9 B parameters): ``Engine`` with
   paged decode, 4 requests of 512 to 2048 prompt tokens and 16 to 32 new
   tokens, twice: the same tokens both times, 16 flash launches per
   prefill, all in the wgmma instance at D = 128, no plain attention call.
   Holds the kernel against its plain version on layer 0's real q, k, v
   ``[1,2048,16,128]`` with the planted faults, timed beside
   ``scaled_dot_product_attention``; prints prefill and decode times, peak
   memory and the device busy share.
11. The scan phase: holds the selective-scan kernel against its plain
   version (the reference's chunked associative scan) within
   ``selective_scan.agreement``'s limits (those of ``rwkv6.agreement``) on
   y and the final state, at jamba's Di 8192, N 16: ``[1,2048]``,
   ``[4,2048]`` and a ragged ``[1,1000]``, bf16 and fp32; shows that two
   planted faults (the decay dropped, b_t one step late) fail that check;
   times the kernel and the plain version beside the bound.
12. The jamba phase: serves jamba-v0.1-52b at its published width (d 4096,
   32 heads / 8 kv of 128, ff 14336, 16 experts top-2, d_state 16, bf16
   weights drawn from ``--seed``), cut to 8 of its 32 layers (one period of
   the 1:7 interleave, attention at layer 4, MoE on the odd layers; 13.27 B
   parameters): ``Engine.generate`` on ``[1, 2048]`` and ``[4, 512]`` (+16
   each), twice on the same weights with the same tokens; per prefill 1
   flash launch (wgmma) and 7 ``selective_scan`` launches and nothing else,
   no plain attention or plain scan call. Holds flash against its plain
   version on layer 4's real q, k, v, timed beside SDPA; prints prefill and
   decode times, peak memory and the device busy share. Then, in fp32 at
   full width and 5 layers (the MoE keeping every pick), decoding one step
   from a prefill of T - 1 tokens must give the logits and greedy token of
   a prefill of T, and zeroed conv and ssm states must fail that check.
13. The whisper phase: serves whisper-small at full width and depth (12 +
   12 layers, bf16 weights drawn from ``--seed``) on 1500 stub frames a
   request: ``Engine.generate`` on ``[4, 4]`` and ``[2, 64]`` (+32 each),
   twice, the same tokens; 36 flash launches per prefill (12 encoder, 12
   decoder self, 12 cross) and nothing else. Holds flash at the encoder's
   ``[1,1500,12,64]`` (layer 0's real q, k, v) and the cross shape
   ``[1,64,12,64] x [1,1500,12,64]``, beside SDPA; prints times, peak
   memory and the device busy share.
13b. The serve-CLI phase: ``repro_torch.launch.serve.main`` at full width
   on the card for llama3.2-1b, rwkv6-1.6b and whisper-small, each twice
   with ``--batch 4 --prompt-len 512 --max-new 16``: the same tokens both
   times and from ``Engine.generate`` driven directly on the same seeds,
   inside the vocab, ``flash_attention`` or ``rwkv6`` launched in each run;
   tokens/s printed beside the card's name and power limit, and a
   ``{"serve_cli": ...}`` line.
14. The flash-backward phase: holds ``flash_attention_bwd`` (dq, dk and dv
   from q, k, v, o, dO and the forward kernel's own lse) against its plain
   version within ``flash_attention.grad_agreement``'s limits at llama3.2-1b's
   training shape ``[4,2048,32/8,64]`` causal, olmoe's and jamba's D = 128,
   whisper-small's encoder ``[8,1500,12,64]`` (non-causal), decoder-self
   ``[8,448]`` and cross (T 448, S 1500) shapes, one fp32 shape and rows that
   see no key (zero dq there); the same bits twice (no atomics); three
   planted faults (D omitted, the scale dropped from dK, the GQA sum over
   one head) must fail the check; times the kernel, the plain version and
   SDPA's backward (the yardstick, k and v repeated to the q-heads outside
   the timing) beside the bound.
14b. The recurrent-backward phase: holds ``rwkv6_bwd`` (dr, dk, dv, dw, du
   and the start state's gradient) and ``selective_scan_bwd`` (du, ddt, da,
   db, dc, from the forward launch's checkpoints) against
   ``torch.autograd.grad`` of their plain forwards within their
   ``grad_agreement`` (the flash backward's limits) at the training
   microbatches (rwkv6-1.6b ``[2,2048,32,64]`` bf16; jamba ``[1,2048,8192,
   16]`` bf16 on the model's strided views), fp32 with fast decay and both
   state gradients, and a ragged T; the routed instance (``rwkv6_bwd``:
   ``chunked`` for bf16, ``sweep`` for fp32; ``selective_scan_bwd``:
   ``tma``) and ``sweep`` beside it, each within the limits and the two
   within them of each other; the same bits twice; the scan's backward also
   from the ``simple`` instance's checkpoints; five planted faults for
   WKV-6 (dw's sign flipped on the last tile, du without a head, the
   reverse sweep a step late, a chunk state from the wrong chunk, a gate
   referenced to the wrong sub-chunk) and three for the scan (h_{t-1} from
   the wrong tile, e_t one step off in G's chain, db without one block's
   partial) must fail; the chunked kernel against its own plain version,
   and on fp32 operands (never routed there) within bf16's relative
   Frobenius limit, its reading against fp32's printed; times both
   instances of each interleaved (sweep, new, new, sweep; CUDA graphs)
   beside the plain versions, autograd of the plain forward and the
   function's bound (at TF32's rate for ``chunked``), and the scan's
   checkpointing forward beside the serve forward.
15. The train phase: llama3.2-1b at full width and depth (bf16 weights from
   ``--seed``, fp32 AdamW, remat per layer) through
   ``launch.train.train_loop`` on one repeated batch of 4 x 2048 tokens for
   8 steps: per step 32 flash forward launches (wgmma, lse written; 16 of
   them remat's recompute) and 16 backward (mma_sync), no plain attention,
   and the last loss below the first by ``TRAIN_DROP``; prints loss, lr and
   gnorm per step, ms per step, tokens/s and peak memory.  Then, at full
   width cut to 2 layers: 4 steps uninterrupted against 2 steps, a
   checkpoint through ``CheckpointManager`` (restored bit for bit) and 2
   resumed steps (losses within ``RESUME_TOL``); one fp32 step's loss and
   gradients through the kernels against plain attention under autograd
   (``CUT_TOL``); whisper-small at full width, 8 x 448 tokens on 1500
   frames, 3 steps through ``make_train_step`` (72 forward and 36 backward
   launches a step); rwkv6-1.6b at full width and depth (24 layers, bf16)
   through ``train_loop`` on one repeated batch of 4 x 2048 tokens in its 2
   microbatches for 8 steps: 96 ``rwkv6`` and 48 ``rwkv6_bwd`` launches a
   step (every one ``chunked``) and nothing else, the loss falling by
   ``RWKV_TRAIN_DROP``;
   jamba-v0.1-52b at its published width cut to its first 2 layers (Mamba +
   dense MLP, Mamba + MoE; 3.73 B parameters) in its 4 microbatches for 6
   steps: 16 ``selective_scan`` (the ``tma`` instance, with checkpoints)
   and 8 ``selective_scan_bwd`` launches a step (every one ``tma``), the
   loss falling by
   ``JAMBA_TRAIN_DROP``; ms per step, tokens/s, peak memory and a profiled
   step's device busy share for each; and a reduced fp32 step of each
   family on the card against the CPU's (loss, gnorm and every weight
   within ``STEP_TOL``).
16. Prints one ``{"train": ...}`` line, one ``{"jamba": ..., "whisper":
   ...}`` line, one ``{"kernels": [...]}`` line and, last, the ``{"ok":
   true, "device": {...}}`` line.

Any failed check raises and the script exits non-zero.
"""
import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the package's work formulas (what each kernel must move and compute) and
# the NVIDIA H100 SXM data sheet's rates (dense); the kernels' meta
# branches report the same formulas to the dry-run's tally
sys.path.insert(0, os.path.join(ROOT, "src"))
# the multi-rank harness the card tests and tools/multicard_train.py share
sys.path.insert(0, os.path.join(ROOT, "tools"))
import multicard_train as mc  # noqa: E402
from repro_torch.kernels.work import (  # noqa: E402
    BF16_OPS_PER_S,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    TF32_OPS_PER_S,
    attn_work,
    bwd_work,
    fold_work,
    limbs,
    mm_work,
    pe_work,
    scan_bwd_work,
    scan_work,
    wkv_bwd_work,
    wkv_work,
)

D_MODEL, VOCAB = 2048, 128256      # llama3.2-1b: hidden size, vocabulary
MAIN_BLOCKS = 63                   # choose_block(2, 2, 1, 2048, 128256) -> m = 2048
N_LAYERS, N_HEADS, N_KV, HEAD_DIM = 16, 32, 8, 64   # llama3.2-1b attention

# the serve phase: 8 requests on 4 lanes, KV blocks of 16 slots
SERVE_PROMPTS = (2048, 128, 1024, 512, 2048, 512, 128, 1024)
SERVE_MAX_NEW = (32, 8, 24, 16, 8, 32, 16, 24)
SERVE_LANES, SERVE_BLOCK = 4, 16


# the remote phase: the lm_head's first 8192 columns, 4 blocks at m = 2048
REMOTE_M, REMOTE_COLS = 2048, 8192

# the sharded phase: the main path's lm_head on a mesh of 4 shards of one card
SHARDS = 4

# the moe phase: olmoe-1b-7b, 4 requests on 4 lanes (KV blocks of SERVE_BLOCK)
MOE_PROMPTS = (2048, 512, 1024, 2048)
MOE_MAX_NEW = (32, 16, 24, 16)
MOE_LANES = 4

# the rwkv phase: rwkv6-1.6b, 24 layers, d 2048 = 32 heads of 64; two
# Engine.generate calls of (batch, prompt tokens, max_new)
RWKV_LAYERS, RWKV_HEADS, RWKV_HEAD = 24, 32, 64
RWKV_CALLS = ((4, 2048, 32), (1, 1000, 16))
# the scan phase: (B, T) at jamba's Di 8192 = 2 x 4096 and N 16; [1,2048]
# and [4,512] are the jamba phase's served prefills
SCAN_DI, SCAN_N = 8192, 16
SCAN_SHAPES = ((1, 2048), (4, 2048), (1, 1000), (4, 512))
# the special-function unit: 16 results a clock per SM (ex2) at the H100
# SXM's 1.98 GHz boost clock
MUFU_PER_SM_CLOCK, SM_CLOCK_HZ = 16, 1.98e9
# the jamba phase: jamba-v0.1-52b cut to one period of its interleave; two
# Engine.generate calls of (batch, prompt tokens, max_new); the fp32 state
# check at 5 layers (layer 4 is the attention layer)
JAMBA_LAYERS, JAMBA_STATE_LAYERS = 8, 5
JAMBA_CALLS = ((1, 2048, 16), (4, 512, 16))
# the whisper phase: whisper-small, 1500 encoder frames a request
WHISPER_FRAMES = 1500
WHISPER_CALLS = ((4, 4, 32), (2, 64, 32))
# the serve-CLI phase: python -m repro_torch.launch.serve at full width, each
# arch twice, and the kernel each run must launch
SERVE_CLI_ARCHS = (("llama3.2-1b", "flash_attention"), ("rwkv6-1.6b", "rwkv6"),
                   ("whisper-small", "flash_attention"))
SERVE_CLI_BATCH, SERVE_CLI_PROMPT, SERVE_CLI_NEW = 4, 512, 16
# torch's elementwise operators (aten names, in-place forms included): none
# of them may run over the I-points of a main-path block
ELEMENTWISE = {"add", "sub", "mul", "where", "remainder", "bitwise_and",
               "bitwise_right_shift", "__rshift__", "__and__", "ge", "lt",
               "fmod"}

# decode from a prefill of T tokens against a prefill of T + 1, in fp32:
# the next-token logits may differ by this share of their rms
STATE_TOL = 1e-3


class SmokeFailure(RuntimeError):
    """A check of this script did not hold."""


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def elementwise(key):
    """Whether a profiler key names one of :data:`ELEMENTWISE`."""
    if not key.startswith("aten::"):
        return False
    name = key[len("aten::"):]
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                   # in place: add_ -> add
    return name in ELEMENTWISE


def bound(nbytes, ops, ops_per_s=INT8_OPS_PER_S):
    """(ms, 'bytes'|'operations'): the least time an H100 could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, causal):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same ``[B, T, H, D]`` operands (timed only; the port never calls
    it)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)


def wkv_faults(r, k, v, w, u):
    """Three wrong results for the check against the plain version to
    reject, each made with the plain version: the bonus ``u`` set to zero;
    the output read from ``S_t`` instead of ``S_{t-1}`` (``r_t . (S_t +
    diag(u) k_t^T v_t)`` = the plain output of ``r * decay`` with no bonus,
    plus ``v_t (r_t . (1 + u) k_t)``); and the final state without the
    last 64 steps."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6_plain

    yield "out: u = 0", "out", rwkv6_plain(r, k, v, w, torch.zeros_like(u))[0]
    rf, kf, vf, uf = r.float(), k.float(), v.float(), u.float()
    decay = torch.exp(-torch.exp(w.float()))
    after, _ = rwkv6_plain(rf * decay, kf, vf, w, torch.zeros_like(uf))
    bonus = torch.einsum("bthk,hk,bthk->bth", rf, 1 + uf, kf)
    yield "out: read from S_t", "out", after + vf * bonus[..., None]
    yield "state: last 64 steps dropped", "state", rwkv6_plain(
        r[:, :-64], k[:, :-64], v[:, :-64], w[:, :-64], u)[1]


def rwkv_phase(torch, np, dev, seed, gen):
    """Serve rwkv6-1.6b at full width and depth on the card, twice from one
    seed, with the WKV kernel held against its plain version.

    Returns the kernel's record for the ``kernels`` line."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rwkv6 import agreement, rwkv6, rwkv6_plain
    from repro_torch.models import rwkv as rw
    from repro_torch.models.layers import rms_norm
    from repro_torch.serve import Engine

    cfg = get_config("rwkv6-1.6b")
    require((cfg.family, cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
             cfg.dtype) == ("ssm", RWKV_LAYERS, RWKV_HEADS * RWKV_HEAD, 7168,
                            65536, "bfloat16"),
            f"rwkv6-1.6b config changed: {cfg}")

    def hold(what, ops, *, state0=None, controls=False):
        """The kernel against its plain version on ``ops`` (r, k, v, w, u):
        output and final state within ``agreement``'s limits; with
        ``controls``, three planted faults must fail the same check."""
        out, state = rwkv6(*ops, state0=state0)
        want_out, want_state = rwkv6_plain(*ops, state0=state0)
        torch.cuda.synchronize()
        require(out.shape == want_out.shape and state.shape == want_state.shape,
                f"{what}: {tuple(out.shape)} {tuple(state.shape)}")
        require(bool(torch.isfinite(out).all() and torch.isfinite(state).all()),
                f"{what}: non-finite result")
        a_out, a_state = agreement(out, want_out), agreement(state, want_state)
        require(a_out["ok"] and a_state["ok"], f"{what}: kernel != plain "
                f"(out {readings(a_out)}, worst at {a_out['worst_at']}; state "
                f"{readings(a_state)}, worst at {a_state['worst_at']})")
        print(f"  {what}: out {readings(a_out)}; state {readings(a_state)}",
              flush=True)
        if controls:
            refs = {"out": want_out, "state": want_state}
            for fault, which, bad in wkv_faults(*ops):
                a = agreement(bad, refs[which])
                require(not a["ok"], f"{what}: the check accepts a planted "
                        f"fault ({fault}: {readings(a)})")
                print(f"    control, {fault}: rejected ({readings(a)}; "
                      f"{a['rel_frob'] / 1e-5:.3g} times the Frobenius limit)",
                      flush=True)
        return max(a_out["max_abs_err"], a_state["max_abs_err"])

    def draw(b, t, dtype, w_mean):
        shape = (b, t, RWKV_HEADS, RWKV_HEAD)
        r, k, v, w = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(4))
        u = torch.randn((RWKV_HEADS, RWKV_HEAD), generator=gen, device=dev)
        return tuple(x.to(dtype) for x in (r, k, v, w + w_mean)) + (u,)

    # ------------------------------------------ the kernel on random operands
    print("rwkv6 kernel checks (rwkv6-1.6b: H 32, K = V = 64; w ~ N(-6, 1) as "
          "w_base gives, or N(0, 1): decay e^-1 per step):", flush=True)
    rec = {}
    for b, t, _ in RWKV_CALLS:
        for dtype in (torch.bfloat16, torch.float32):
            for w_mean in (-6.0, 0.0):
                for with_s0 in (False, True):
                    ops = draw(b, t, dtype, w_mean)
                    s0 = (torch.randn((b, RWKV_HEADS, RWKV_HEAD, RWKV_HEAD),
                                      generator=gen, device=dev)
                          if with_s0 else None)
                    name = str(dtype).split(".")[-1]
                    served = dtype == torch.bfloat16 and w_mean == -6.0
                    err = hold(f"[{b},{t},32,64] {name}, w ~ N({w_mean:g}, 1), "
                               f"{'state0' if with_s0 else 'zero state'}",
                               ops, state0=s0,
                               controls=served and not with_s0)
                    if served and not with_s0:
                        nbytes, flops = wkv_work(b, t, RWKV_HEADS, 2, False)
                        rec[(b, t)] = {
                            "max_abs_err": err,
                            "ms": time_ms(torch, lambda: rwkv6(*ops), 20),
                            "plain_ms": time_ms(torch, lambda: rwkv6_plain(*ops),
                                                1),
                            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                            "fp32_ops_ms": flops / FP32_OPS_PER_S * 1e3}
                        r = rec[(b, t)]
                        print(f"    kernel {r['ms']:.4f} ms, plain "
                              f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f}"
                              f" ms (bytes: {nbytes / 1e6:.1f} MB); the "
                              f"sequential form's {flops / 1e9:.2f} GFLOP take "
                              f"{r['fp32_ops_ms']:.4f} ms at the fp32 peak",
                              flush=True)
                    del ops, s0
    torch.cuda.empty_cache()

    # --------------------------------------------- serving, twice from a seed
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (b, t)) for b, t, _ in RWKV_CALLS]

    def serve_once(what):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()     # earlier phases' tensors
        t0 = time.perf_counter()
        params = rw.init_params(cfg, seed, device=dev)
        torch.cuda.synchronize()
        nbytes = sum(x.numel() * x.element_size() for x in params.parameters())
        draw_s = time.perf_counter() - t0
        eng = Engine(cfg, params)
        require(eng.device.type == "cuda" and not eng._paged,
                f"{what}: engine on {eng.device}, paged {eng._paged}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain0 = rwkv6_plain.calls
        reset_launch_counts()
        toks, walls = [], []
        for i, (pr, (b, t, n)) in enumerate(zip(prompts, RWKV_CALLS,
                                                strict=True)):
            t0 = time.perf_counter()
            out = eng.generate(pr, n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = launch_counts()["rwkv6"]
            require(got == cfg.n_layers * (i + 1),
                    f"{what}: {got} rwkv6 launches after {i + 1} prefills")
            out = out.cpu().numpy()
            require(out.shape == (b, n), f"{what}: tokens {out.shape}")
            require(bool(((out >= 0) & (out < cfg.vocab)).all()),
                    f"{what}: token outside the vocabulary")
            toks.append(out)
        counts = launch_counts()
        plain = rwkv6_plain.calls - plain0
        peak = torch.cuda.max_memory_allocated()
        require(counts == {"modmatmul_batched": 0, "modmatmul": 0,
                           "polyeval": 0, "flash_attention": 0,
                           "flash_attention_bwd": 0,
                           "rwkv6": cfg.n_layers * len(RWKV_CALLS),
                           "rwkv6_bwd": 0, "ring_fold": 0,
                           "selective_scan": 0, "selective_scan_bwd": 0},
                f"{what}: launch counts {counts}")
        require(plain == 0, f"{what}: {plain} plain WKV calls on the card")
        print(f"  {what}: weights drawn in {draw_s:.2f} s; generate "
              + ", ".join(f"[{b},{t}] + {n}: {w * 1e3:.1f} ms wall"
                          for (b, t, n), w in zip(RWKV_CALLS, walls,
                                                  strict=True))
              + f"; launches {counts}, plain WKV calls {plain}; peak memory "
              f"{peak / 2**30:.3f} GiB, of which {before / 2**30:.3f} GiB was "
              f"held before the weights were drawn", flush=True)
        return params, toks, counts, nbytes

    print(f"rwkv serve: {cfg.name} at its published config ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {rw.n_heads(cfg)} heads of {rw.HEAD_K}, ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), weights drawn from seed "
          f"{seed}; Engine.generate {list(RWKV_CALLS)} (batch, prompt, max_new)",
          flush=True)
    params, first, counts, nbytes = serve_once("run 1")
    del params
    torch.cuda.empty_cache()
    params, second, _, _ = serve_once("run 2 (weights drawn again)")
    require(all(np.array_equal(a, b) for a, b in zip(first, second, strict=True)),
            "rwkv serve: a second run from the same seed gave other tokens")
    print(f"  run 2 tokens equal run 1's; {nbytes / 1e9:.3f} GB of weights "
          f"({sum(x.numel() for x in params.parameters()) / 1e9:.3f} B "
          f"parameters)", flush=True)

    # time to first token, and decode steps from the prefill's state
    floor = nbytes / HBM_BYTES_PER_S * 1e3
    for pr, (b, t, _) in zip(prompts, RWKV_CALLS, strict=True):
        tok = torch.as_tensor(pr, device=dev)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = rw.prefill(cfg, params, tok)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        nxt = logits[:, -1:].argmax(-1)
        steps = []
        for i in range(8):
            t0 = time.perf_counter()
            logits, cache = rw.decode_step(cfg, params, cache, nxt, t + i)
            nxt = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        print(f"  [{b},{t}]: prefill {min(runs):.2f} ms (host clock around a "
              f"synchronised call, best of 3); decode {sum(steps) / 8:.2f} ms "
              f"mean, {min(steps):.2f} ms min per step over 8 steps = "
              f"{b * 8e3 / sum(steps):.1f} tokens/s; the weight-read floor is "
              f"{floor:.3f} ms per step ({sum(steps) / 8 / floor:.1f}x)",
              flush=True)
        del logits, cache
    tok0 = torch.as_tensor(prompts[0], device=dev)
    device_share(torch, f"prefill [{RWKV_CALLS[0][0]},{RWKV_CALLS[0][1]}]",
                 lambda: rw.prefill(cfg, params, tok0), "wkv")
    _, cache = rw.prefill(cfg, params, tok0)
    nxt = tok0[:, -1:]
    device_share(torch, f"4 decode steps at batch {RWKV_CALLS[0][0]}",
                 lambda: [rw.decode_step(cfg, params, cache, nxt, 0)
                          for _ in range(4)], "wkv")
    del cache

    # the kernel on the r, k, v, w, u that layer 0 makes of the served prompt
    lp = params.layers[0]
    x = params.embed[tok0]
    h = rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    r, k, v, w, _ = rw._time_mix_inputs(cfg, h, torch.zeros_like(h[:, 0]), lp)
    hold(f"layer 0's r, k, v, w, u of the served [{tok0.shape[0]},"
         f"{tok0.shape[1]}] prompt (bf16)", (r, k, v, w, lp["u_bonus"]),
         controls=True)
    del x, h, r, k, v, w

    # the state prefill hands to decode: decode one step from a prefill of
    # T - 1 tokens against a prefill of all T, in fp32 (a copy of the served
    # weights) so that bf16 rounding does not hide a fault; a zeroed WKV
    # state must fail the same check
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = copy.deepcopy(params).float()
    del params
    torch.cuda.empty_cache()
    want, _ = rw.prefill(cfg32, p32, tok0)

    def from_state(what, zero):
        _, cache = rw.prefill(cfg32, p32, tok0[:, :-1])
        if zero:
            cache.wkv.zero_()
        got, _ = rw.decode_step(cfg32, p32, cache, tok0[:, -1:],
                                tok0.shape[1] - 1)
        rms = float(want.float().pow(2).mean().sqrt())
        diff = float((got - want).abs().max())
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        print(f"  {what}: next-token logits max |diff| {diff:.3e} = "
              f"{diff / rms:.3e} of their rms (limit {STATE_TOL:g}); greedy "
              f"tokens {'equal' if same else 'differ'}", flush=True)
        return diff <= STATE_TOL * rms and same

    require(from_state(f"decode from a prefill of {tok0.shape[1] - 1} tokens "
                       f"vs a prefill of {tok0.shape[1]} (fp32)", False),
            "the state handed to decode disagrees with a longer prefill")
    require(not from_state("control, decode from a zeroed WKV state", True),
            "the state check accepts a zeroed WKV state")
    del p32, want
    torch.cuda.empty_cache()

    served = rec[RWKV_CALLS[0][:2]]
    small = rec[RWKV_CALLS[1][:2]]
    b, t, _ = RWKV_CALLS[0]
    return {
        "name": "rwkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:27",
        "launches": counts["rwkv6"],
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "fp32_ops_ms": served["fp32_ops_ms"],
        "shape": f"bf16 r, k, v, w [{b},{t},32,64], fp32 out and state",
        "path": "rwkv serve prefill",
        "at_1x1000": {key: small[key] for key in
                      ("ms", "plain_ms", "bound_ms", "max_abs_err")},
    }


def skinny_checks(torch, dev, gen, sms):
    """The ``skinny`` instance (``csrc/modmatmul_skinny.cu``) against its
    plain version, ``torch.equal``, at the MAC tags' shape, an 8-lane wave,
    a ragged (odd) K and the all-(p-1) corner, both primes; timed with
    CUDA events beside the plain version, the earlier ``cuda_core``
    instance and the bytes bound.  Returns the records for the ``kernels``
    line, keyed ``("modmatmul", p)`` and ``("modmatmul_wave", p)``."""
    from repro_torch.kernels import modmatmul as mm_mod
    from repro_torch.kernels.modmatmul import (
        choose_instance,
        modmatmul,
        modmatmul_batched,
        modmatmul_plain,
        skinny_blocks,
        skinny_rows,
    )
    from repro_torch.analysis.overflow import certified_window
    from repro_torch.mpc import P_DEFAULT, P_MERSENNE31

    col = 1024 * 1024

    def rand(p, *shape):
        return torch.randint(0, p, shape, generator=gen, device=dev)

    def hold(what, kern, a, b, p, iters=0, want=None):
        got, ref = kern(a, b, p=p), modmatmul_plain(a, b, p=p)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and torch.equal(got, ref),
                f"{what}: kernel != plain")
        if want is not None:
            require(bool((got == want).all()), f"{what}: != closed form")
        rec = {"max_abs_err": 0}
        if iters:
            rec["ms"] = time_ms(torch, lambda: kern(a, b, p=p), iters)
            rec["device_ms"] = graph_ms(torch, lambda: kern(a, b, p=p), iters)
            rec["plain_ms"] = time_ms(torch, lambda: modmatmul_plain(a, b, p=p),
                                      3)
        print(f"  {what}: equal", flush=True)
        return rec

    def cuda_core(a, b, p):
        return mm_mod._launch(a[None], b[None], p=p, instance="cuda_core")[0]

    require(choose_instance(1, 17, col, 1) == "skinny"
            and choose_instance(8, 17, col, 1) == "skinny",
            "the tags' product does not take the skinny instance")
    out = {}
    for p in (P_DEFAULT, P_MERSENNE31):
        print(f"skinny instance checks, p = {p} ({skinny_rows(17, 1)} rows a "
              f"block; {skinny_blocks(1, 17, col, 1, sms)} blocks share K at "
              f"W = 1, {skinny_blocks(8, 17, col, 1, sms)} per lane at W = 8):",
              flush=True)
        a, b = rand(p, 17, col), rand(p, col, 1)
        r = hold(f"modmatmul [17,{col}]@[{col},1] (the tags; skinny, chosen)",
                 modmatmul, a, b, p, iters=20)
        old = hold(f"modmatmul [17,{col}]@[{col},1] (cuda_core, the earlier "
                   f"instance, split K)", cuda_core, a, b, p, iters=5)
        w = mm_work(1, 17, col, 1, p)
        bms = bound(*w)[0]
        print(f"    skinny {r['ms']:.4f} ms over a loop of launches, "
              f"{r['device_ms']:.4f} ms of device time in a CUDA graph; "
              f"cuda_core {old['ms']:.4f} / {old['device_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.4f} ms; bound {bms:.4f} ms (bytes, "
              f"{w[0] / 1e6:.1f} MB): {100 * bms / r['device_ms']:.1f} % of the "
              f"bound, {old['device_ms'] / r['device_ms']:.2f}x faster than "
              f"cuda_core", flush=True)
        out[("modmatmul", p)] = dict(r, work=w, earlier={
            "instance": "cuda_core", "ms": old["ms"],
            "device_ms": old["device_ms"],
            "speedup": old["device_ms"] / r["device_ms"]})
        del a, b
        a, b = rand(p, 8, 17, col), rand(p, 8, col, 1)
        r = hold(f"modmatmul_batched [8,17,{col}]@[8,{col},1] (an 8-lane "
                 f"wave's tags; skinny)", modmatmul_batched, a, b, p, iters=10)
        w = mm_work(8, 17, col, 1, p)
        bms = bound(*w)[0]
        print(f"    skinny {r['ms']:.4f} ms over a loop of launches, "
              f"{r['device_ms']:.4f} ms in a CUDA graph; plain "
              f"{r['plain_ms']:.4f} ms; bound {bms:.4f} ms (bytes, "
              f"{w[0] / 1e9:.3f} GB): {100 * bms / r['device_ms']:.1f} % of "
              f"the bound", flush=True)
        out[("modmatmul_wave", p)] = dict(r, work=w)
        del a, b
        k = col - 3                            # odd K: the scalar loads
        hold(f"modmatmul ragged [17,{k}]@[{k},1]", modmatmul,
             rand(p, 17, k), rand(p, k, 1), p)
        hold(f"modmatmul_batched ragged [3,17,{k}]@[3,{k},1]",
             modmatmul_batched, rand(p, 3, 17, k), rand(p, 3, k, 1), p)
        k = 2 * certified_window(p) + 1        # the window certificate's edge
        for kk in (k, col):
            full = torch.full((17, kk), p - 1, dtype=torch.int64, device=dev)
            hold(f"modmatmul all-(p-1) corner [17,{kk}]@[{kk},1]", modmatmul,
                 full, full[0].reshape(kk, 1).contiguous(), p,
                 want=pow(p - 1, 2, p) * kk % p)
        del full
        torch.cuda.empty_cache()
    return out


def batched_phase(torch, np, dev, a, b, local_walls):
    """The full-width lm_head through the batched backend: (a) the default
    policy, (b) a verified spec in 8-lane waves, (c) the same under a
    scripted ``FaultInjector``; then attrition through the autotuner.
    Each call exact, its launches read per wave with the counters zeroed
    just before it.  Returns the ``kernels`` line's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.modmatmul import modmatmul_plain
    from repro_torch.mpc import P_DEFAULT, FaultInjector, MPCSpec, connect

    p = P_DEFAULT
    want = modmatmul_plain(a, b, p=p)

    def drive(what, sess):
        eng = sess.backend.engine
        waves0 = eng.stats["waves"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        y = sess.matmul(a, b, encoded=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, inst = launch_counts(), instance_counts()["modmatmul_batched"]
        waves = eng.stats["waves"] - waves0
        require(y.shape == want.shape and torch.equal(y, want),
                f"{what}: != exact (A @ B) mod p")
        require(counts["modmatmul"] == 0 and counts["flash_attention"] == 0
                and counts["rwkv6"] == 0, f"{what}: launches {counts}")
        require(inst["cuda_core"] == 0 and inst["tensor_core"] == waves,
                f"{what}: {waves} waves, modmatmul_batched instances {inst}")
        print(f"  {what}: exact; {wall * 1e3:.1f} ms wall, {waves} waves; "
              f"per wave {counts['polyeval'] / waves:g} polyeval, "
              f"{inst['tensor_core'] / waves:g} tensor_core and "
              f"{inst['skinny'] / waves:g} skinny modmatmul_batched "
              f"(launches {counts}, instances {inst})", flush=True)
        return wall, counts, inst, waves

    print(f"batched backend: the lm_head [1,{D_MODEL}] x [{D_MODEL},{VOCAB}] "
          f"(p = {p}, encoded); the local backend took "
          f"{[round(x * 1e3, 1) for x in local_walls]} ms per call (phase 5)",
          flush=True)
    walls = {"local": [x * 1e3 for x in local_walls]}
    sess_a = connect(MPCSpec(s=2, t=2, z=2), backend="batched")
    runs = [drive(f"(a) default policy, call {i}", sess_a) for i in range(2)]
    for _, counts, inst, waves in runs:
        require(waves == MAIN_BLOCKS and counts["polyeval"] == 4 * waves
                and inst["skinny"] == 0,
                f"(a): {waves} waves, {counts}, {inst}: not the width-1 path")
    walls["a"] = [r[0] * 1e3 for r in runs]

    verified = MPCSpec(s=2, t=2, z=2, adversaries=1)
    sess_b = connect(verified, backend="batched", max_batch=8,
                     wave_scalars=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [drive(f"(b) adversaries=1, 8-lane waves, call {i}", sess_b)
            for i in range(2)]
    peak = torch.cuda.max_memory_allocated()
    for _, counts, inst, waves in runs:
        require(waves == 8 and counts["polyeval"] == 4 * waves
                and inst["skinny"] == 2 * waves,
                f"(b): {waves} waves, {counts}, {inst}")
    walls["b"] = [r[0] * 1e3 for r in runs]
    skinny_launches = runs[0][2]["skinny"]
    require(sess_b.stats["corrections"] == 0 and not sess_b._dead,
            f"(b): honest shares flagged: {sess_b.stats}")

    sched = {5: [(2, "tamper")], 20: [(4, "tag")]}
    inj = FaultInjector(seed=11, schedule=sched)
    sess_c = connect(verified, backend="batched", max_batch=8,
                     wave_scalars=None, injector=inj)
    wall, counts, inst, waves = drive(
        f"(c) the same under FaultInjector schedule {sched}", sess_c)
    # the two waves holding a liar decode two survivor patterns
    require(waves == 8 and counts["polyeval"] == 4 * waves + 2
            and inst["skinny"] == 2 * waves,
            f"(c): {waves} waves, {counts}, {inst}")
    log = [(5, 2, "tamper"), (20, 4, "tag")]
    require(inj.log == log, f"(c): injector log {inj.log} != {log}")
    require(sess_c.stats["corrections"] == 2
            and sess_c.stats["evicted_devices"] == 2
            and sess_c._dead == {2, 4},
            f"(c): stats {sess_c.stats}, dead {sess_c._dead}")
    print(f"    byzantine_stats {sess_c.backend.byzantine_stats()}, evicted "
          f"{sorted(sess_c._dead)}, injector log {inj.log}", flush=True)
    again = drive("(c) next call, liars evicted", sess_c)
    require(again[1]["polyeval"] == 4 * again[3], f"(c) again: {again[1]}")
    walls["c"] = [wall * 1e3, again[0] * 1e3]
    print(f"  wall ms per call: local {[round(x, 1) for x in walls['local']]}, "
          f"(a) {[round(x, 1) for x in walls['a']]}, (b) "
          f"{[round(x, 1) for x in walls['b']]}, (c) "
          f"{[round(x, 1) for x in walls['c']]} (injected, then clean); peak "
          f"memory of (b) {peak / 2**30:.2f} GiB (max_memory_allocated)",
          flush=True)

    # where one verified call's device time goes, copies included
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess_b.matmul(a, b, encoded=True)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    busy = sum(r[0] for r in rows)
    copies = [r for r in rows if any(w in r[2].lower() for w in
                                     ("copy", "cat", "memcpy", "stack"))]
    print(f"device time of one verified call (b) (torch.profiler): "
          f"{busy / 1e3:.3f} ms in {sum(r[1] for r in rows)} device events; "
          f"copies {sum(r[0] for r in copies) / 1e3:.3f} ms in "
          f"{sum(r[1] for r in copies)}", flush=True)
    for us, count, key in rows[:14]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f} %  "
              f"x{count:<4d} {key[:100]}")

    # attrition: 3 of (a)'s 19 provisioned workers die, the pool drops
    # below N = 17, and the engine re-tunes through ElasticPool.retune ->
    # autotune.retune_spec before the next call
    eng = sess_a.backend.engine
    sess_a.fail([0, 1, 2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = sess_a.matmul(a, b, encoded=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(torch.equal(y, want), "attrition: != exact (A @ B) mod p")
    served = list(eng._replans.values())
    require(eng.stats["replans"] == 1 and eng.stats["retunes"] == 1
            and len(served) == 1,
            f"attrition: replans {eng.stats['replans']}, retunes "
            f"{eng.stats['retunes']}")
    spec = served[0].spec
    print(f"  attrition: 3 workers failed, 16 of 19 alive < N = 17; re-tuned "
          f"to {spec.scheme} s={spec.s} t={spec.t} lam={spec.lam} "
          f"N={spec.n_workers} at m={spec.m}; exact, {wall * 1e3:.1f} ms wall; "
          f"stats replans {eng.stats['replans']}, retunes "
          f"{eng.stats['retunes']}", flush=True)
    walls["attrition"] = [wall * 1e3]
    return {"skinny_launches": skinny_launches, "walls": walls,
            "peak_gib": peak / 2**30}


# (a)'s reply deadline: the thread-mode wire of a block (3 GB through
# Python threads) took up to 20 s a worker on an H100 host and 49 s on a
# slower one, past the transport's default 30 s
REMOTE_DEADLINE_S = 120.0


def remote_phase(torch, dev, a, b, local):
    """The remote backend on the card (phase 6c): the lm_head's first
    ``REMOTE_COLS`` columns at m = 2048 (N = 17, the main path's block)
    over the socket transport.  (a) thread mode, pipelined then
    barriered; (b) a phase-2 death and a phase-3 death; (c) 17 spawned
    processes on the one card; (d) timed stages, calibration from (a)'s
    samples and the divergence gate.  Each call exact; (a)'s launches read
    with the counters zeroed just before it.  Returns the ``kernels``
    line's numbers."""
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.modmatmul import modmatmul_plain
    from repro_torch.mpc import MPCSpec, WorkerPool, connect
    from repro_torch.mpc.protocol import AGECMPCProtocol
    from repro_torch.mpc.workers import WorkerClass
    from repro_torch.sim import PhaseRecorder, calibrate
    from repro_torch.sim.divergence import gate

    t_phase = time.perf_counter()
    m, blk = REMOTE_M, REMOTE_M // 2
    spec = MPCSpec(s=2, t=2, z=2, m=m)
    n = spec.n_workers
    p = spec.field.p
    w = b[:, :REMOTE_COLS].contiguous()
    want = modmatmul_plain(a, w, p=p)
    blocks = REMOTE_COLS // m
    # payload bytes of one block (frame headers aside): shares down, the G
    # row up, the I point down and its echo up, for each of the N workers
    wire = n * 8 * (2 * blk * blk + n * blk * blk + 2 * blk * blk)
    y_loc = local.matmul(a, w, encoded=True, m=m)
    require(torch.equal(y_loc, want), "remote: local backend != exact")
    print(f"remote backend: [1,{D_MODEL}] x [{D_MODEL},{REMOTE_COLS}] at m={m} "
          f"(N={n}, {blocks} blocks), p = {p}, encoded; {wire / 1e9:.3f} GB "
          f"of payload on the wire per block ({n} workers x (shares "
          f"{16 * blk * blk / 1e6:.1f} MB, G row {8 * n * blk * blk / 1e6:.1f} "
          f"MB, I point {8 * blk * blk / 1e6:.1f} MB each way))", flush=True)

    rec = PhaseRecorder()
    # (a) reads the path with no fault: a reply is awaited REMOTE_DEADLINE_S
    # before the driver re-asks (a re-ask recomputes on the worker, so it
    # would add launches to the counts held below)
    sess = connect(spec, backend="remote", recorder=rec,
                   deadline_s=REMOTE_DEADLINE_S)
    require(sess.device == dev and sess.backend.device == dev,
            f"remote session on {sess.device}")

    def spawn(what, sess):
        """Bring the session's dealer up (its workers spawned, each with
        its plan) before any call is timed; returns the seconds it took."""
        t0 = time.perf_counter()
        dealer = sess.backend._dealer(sess.backend.engine.serving_proto(
            AGECMPCProtocol.from_spec(spec)))
        ready = time.perf_counter() - t0
        print(f"  {what}: {len(dealer.links)} workers, {ready:.2f} s from "
              f"spawn to every worker ready", flush=True)
        return dealer, ready

    def call(what, sess, cols, nblocks, counted=True, prof=None):
        """One ``matmul`` of ``h @ W[:, :cols]``, exact against the plain
        product and the local backend; launches counted from zero.  Under
        ``prof`` (a ``torch.profiler.profile``) the call is traced too."""
        be = sess.backend
        blocks0, host0, n0 = be.stats["blocks"], be.dealer_us, len(rec)
        torch.cuda.synchronize()
        reset_launch_counts()
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            y = sess.matmul(a, w[:, :cols], encoded=True, m=m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, inst = launch_counts(), instance_counts()["modmatmul_batched"]
        done = be.stats["blocks"] - blocks0
        require(y.shape == (1, cols) and y.is_cuda
                and torch.equal(y, want[:, :cols])
                and torch.equal(y, y_loc[:, :cols]),
                f"{what}: != exact (A @ B) mod p and the local backend")
        host = (be.dealer_us - host0) / 1e3 / max(done, 1)
        new = rec.samples[n0:]
        per = {ph: [x.us / 1e3 for x in new if x.phase == ph]
               for ph in ("encode", "decode", "compute", "exchange")}

        def stat(ph):
            v = per[ph]
            return (f"mean {sum(v) / len(v):.1f} max {max(v):.1f}" if v
                    else "none")

        print(f"  {what}: exact, equal to the local backend; "
              f"{wall * 1e3:.1f} ms wall, {done} blocks, "
              f"{wall * 1e3 / max(done, 1):.1f} ms per block; dealer host "
              f"{host:.1f} ms per block; launches {counts}", flush=True)
        if new:
            print(f"    per block (ms, recorder): dealer encode "
                  f"{stat('encode')}, decode {stat('decode')}; worker "
                  f"compute (H2D, products, D2H) {stat('compute')}; wire per "
                  f"worker {stat('exchange')}; stats {be.stats}", flush=True)
        if counted:
            require(done == nblocks, f"{what}: {done} blocks != {nblocks}")
            require(counts["modmatmul_batched"] == n * nblocks
                    and inst["tensor_core"] == n * nblocks
                    and counts["polyeval"] == (n + 4) * nblocks
                    and counts["modmatmul"] == 0,
                    f"{what}: launches {counts}, instances {inst}")
        return {"y": y, "wall": wall, "counts": counts, "host": host,
                "blocks": done}

    from torch.profiler import ProfilerActivity, profile

    _, thread_ready = spawn("(a) thread mode", sess)
    # pipelined over all the blocks (more than the window of 2); barriered
    # over 2, traced: the window plays no part there, and the trace splits
    # a counted call's device time between copies and kernels
    sess.backend.pipelined = True
    pipe = call("(a) thread mode, pipelined", sess, REMOTE_COLS, blocks)
    sess.backend.pipelined = False
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    barr = call("(a) thread mode, barriered, under torch.profiler", sess,
                2 * m, 2, prof=prof)
    a_samples = list(rec.samples)
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    copies = sum(e.self_device_time_total for e in rows
                 if "memcpy" in e.key.lower()) / 1e3
    prof_wall = barr["wall"] * 1e3
    print(f"  (a) the barriered call's trace: {prof_wall:.1f} ms wall, "
          f"device busy {busy:.1f} ms ({100 * busy / prof_wall:.1f} %; "
          f"idle {100 - 100 * busy / prof_wall:.1f} %): host<->card copies "
          f"{copies:.1f} ms, kernels {busy - copies:.2f} ms in "
          f"{sum(e.count for e in rows)} device events", flush=True)
    sess.backend.close()

    print("  (b) chaos in thread mode, 2 blocks each:", flush=True)
    chaos = {}
    for point, slot in (("shares", 3), ("ipoint", 5)):
        sess_b = connect(spec, backend="remote")
        sess_b.backend.chaos(AGECMPCProtocol.from_spec(spec), slot,
                             die_block=0, die_after=point)
        wall = call(f"(b) worker {slot} dies after {point!r}", sess_b,
                    2 * m, 2, counted=False)["wall"]
        st, eng = dict(sess_b.backend.stats), sess_b.backend.engine.stats
        print(f"    replans {eng['replans']}, retunes {eng['retunes']}, "
              f"phase_losses {st['phase_losses']}, redispatches "
              f"{st['redispatches']}, phase3_absorbed "
              f"{st['phase3_absorbed']}", flush=True)
        if point == "shares":
            require(st["phase_losses"] >= 1 and st["redispatches"] >= 1
                    and eng["replans"] >= 1,
                    f"(b) phase-2 death not recovered by a replan: {st}")
        else:
            require(st["phase3_absorbed"] >= 1 and st["phase_losses"] == 0,
                    f"(b) phase-3 death not absorbed: {st}")
        chaos[point] = {"wall_ms": wall * 1e3, "stats": st,
                        "replans": eng["replans"], "retunes": eng["retunes"]}
        sess_b.backend.close()

    sess_c = connect(spec, backend="remote", spawn="process")
    dealer, ready = spawn("(c) process mode, one card", sess_c)
    proc_run = call("(c) process mode", sess_c, 2 * m, 2, counted=False)
    require(torch.equal(proc_run["y"], pipe["y"][:, :2 * m]),
            "(c) process mode != (a)'s Y")
    require(proc_run["counts"]["polyeval"] == 4 * 2
            and proc_run["counts"]["modmatmul_batched"] == 0,
            f"(c) the dealer's launches {proc_run['counts']}")
    procs = [ln._process for ln in dealer.links.values()]
    sess_c.backend.close()
    require(len(procs) == n and not any(pr.is_alive() for pr in procs),
            "(c) worker processes left running")
    # the workers' kernels ran in their own processes: each reports its
    # counters as it exits (outside the wire), one W = 1 tensor-core
    # product and one G-row polyeval per block, on this card
    reports = dealer.worker_reports()
    require([r["slot"] for r in reports] == list(range(n))
            and all(r["device"] == str(dev)
                    and r["launches"]["modmatmul_batched"] == 2
                    and r["instances"]["modmatmul_batched"]["tensor_core"] == 2
                    and r["launches"]["polyeval"] == 2
                    for r in reports),
            f"(c) worker processes' launches: {reports}")
    print(f"  (c) each of the {len(reports)} worker processes reports, on "
          f"{reports[0]['device']}, 2 tensor_core modmatmul_batched and 2 "
          f"polyeval launches", flush=True)
    wall_c = proc_run["wall"]

    print("  (d) simulator and timing on the card:", flush=True)
    plan = spec.plan()
    trec = PhaseRecorder()
    stages = plan.stages(dev).timed(trec, plan=plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    at, bt = a.new_zeros((m, m)), w[:, :m]
    at[:, :1] = a.T
    for _ in range(3):
        f_a, f_b = stages.encode(at, bt, gen)
        h = stages.worker_compute(f_a, f_b)
        i_pts = stages.exchange(h, gen)
        idx, rows = plan.survivor_tables(tuple(range(6)), dev)
        y = stages.decode(i_pts, idx, rows)
    # Aᵀ's first column is h: Y's first row is h @ W[:, :m], the rest 0
    require(torch.equal(y[:1], want[:, :m]) and not bool(y[1:].any()),
            "(d) timed stages != exact")
    require(len(trec) == 12 and all(x.device == -1 for x in trec.samples),
            f"(d) timed stages recorded {len(trec)} samples")
    timed = {x.phase: x.us for x in trec.samples[-4:]}
    print(f"    ProtocolStages.timed on the lm_head plan (third call, us): "
          f"{ {k: round(v, 1) for k, v in timed.items()} }", flush=True)
    roster = WorkerPool.homogeneous(n, WorkerClass(spec.scheme))
    cal = calibrate(a_samples, roster)
    mult = cal.multipliers.get(spec.scheme)
    require(mult is not None and all(x > 0 for x in mult),
            f"(d) calibration fitted {cal.multipliers}")
    print(f"    sim.calibrate on (a)'s {cal.samples_used} samples (roster: "
          f"{n} devices of class {spec.scheme!r}, as a pool-free spec labels "
          f"them): (xi, sigma, zeta) multipliers "
          f"{tuple(round(x, 4) for x in mult)}", flush=True)
    rep = gate()
    require(rep.ok, f"(d) divergence gate failed: {rep.describe()}")
    print(f"    sim.divergence.gate() at 1000 devices: ok, "
          + ", ".join(f"{e.label} ratio {e.ratio:.3f}" for e in rep.entries),
          flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"remote phase: {phase_s:.1f} s wall", flush=True)
    out = {
        "launches": pipe["counts"], "blocks": pipe["blocks"],
        "per_block": {k: v / pipe["blocks"]
                      for k, v in pipe["counts"].items()},
        "wall_ms": {"pipelined": pipe["wall"] * 1e3,
                    "barriered_two_blocks_profiled": prof_wall,
                    "process_two_blocks": wall_c * 1e3},
        "profiled_device_ms": {"busy": busy, "copies": copies},
        "thread_ready_s": thread_ready,
        "dealer_host_ms_per_block": {"pipelined": pipe["host"],
                                     "barriered": barr["host"]},
        "wire_bytes_per_block": wire, "process_ready_s": ready,
        "chaos": chaos, "multipliers": list(mult), "timed_us": timed,
        "phase_s": phase_s}
    print(json.dumps({"remote": out}), flush=True)
    return out


def sharded_phase(torch, dev, gen, a, b, hold_float):
    """The sharded backend on the card (phase 6d): the full-width lm_head
    ``[1, 2048] x [2048, 128256]`` (63 blocks at m = 2048, N = 17) through
    ``backend="sharded"`` on a mesh of ``SHARDS`` shards, all on this one
    card (``devices=["cuda:0"] * 4``: N_pad = 20, 5 workers a shard).  For
    both primes, the int64 wire without ``prg_masks`` and the int32 wire
    with them: ``Y`` equal, integer for integer, to the local backend's
    call on the same operands in this phase, and the launches read per
    block from the counters, zeroed just before each counted call.  One
    float call on the int32 wire is held to the float64 product of the
    fixed-point operands.  Returns the ``kernels`` line's numbers."""
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.modmatmul import modmatmul_plain
    from repro_torch.mpc import P_DEFAULT, P_MERSENNE31, Field, MPCSpec, connect
    from repro_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh((SHARDS,), ("model",), devices=[dev] * SHARDS)
    out = {"calls": {}}

    def timed(sess, x, w, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = sess.matmul(x, w, **kw)
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t0) * 1e3

    for p in (P_DEFAULT, P_MERSENNE31):
        spec = MPCSpec(s=2, t=2, z=2, field=Field(p))
        if p == P_DEFAULT:
            x, w = a, b
        else:
            x = torch.randint(0, p, (1, D_MODEL), generator=gen, device=dev)
            w = torch.randint(0, p, (D_MODEL, VOCAB), generator=gen, device=dev)
        n, d = spec.n_workers, SHARDS
        n_pad = -(-n // d) * d
        local = connect(spec)
        y_local, _ = timed(local, x, w, encoded=True)
        require(torch.equal(y_local, modmatmul_plain(x, w, p=p)),
                f"sharded phase, p = {p}: local backend != exact")
        local_ms = [timed(local, x, w, encoded=True)[1] for _ in range(2)]
        print(f"sharded backend, p = {p}: [1,{D_MODEL}] x [{D_MODEL},{VOCAB}] "
              f"on {d} shards of {dev} (N = {n}, N_pad = {n_pad}, "
              f"{n_pad // d} workers a shard); local backend "
              f"{[round(t, 1) for t in local_ms]} ms per call", flush=True)
        for wire, prg in (("int64", False), ("int32", True)):
            what = f"p={p} wire={wire} prg_masks={prg}"
            sess = connect(spec, backend="sharded", mesh=mesh, wire_dtype=wire,
                           prg_masks=prg)
            require(sess.device == dev, f"{what}: session on {sess.device}")
            reset_launch_counts()
            y, first_ms = timed(sess, x, w, encoded=True)
            counts = launch_counts()
            inst = instance_counts()["modmatmul_batched"]
            blocks = sess.stats["blocks"]
            require(blocks == MAIN_BLOCKS, f"{what}: {blocks} blocks")
            require(torch.equal(y, y_local), f"{what}: Y != the local backend's")
            per_block = {k: v / blocks for k, v in counts.items() if v}
            want = {"polyeval": 3 * d + 1, "modmatmul_batched": d}
            if wire == "int32":
                want["ring_fold"] = d * (d - 1)
            require(per_block == want, f"{what}: launches per block "
                    f"{per_block}, want {want}")
            require(inst == {"tensor_core": d * blocks, "skinny": 0,
                             "cuda_core": 0},
                    f"{what}: modmatmul_batched instances {inst}")
            walls = [first_ms]
            for _ in range(2):
                y2, ms = timed(sess, x, w, encoded=True)
                require(torch.equal(y2, y_local), f"{what}: a repeat call != local")
                walls.append(ms)
            print(f"  {what}: equal to the local backend's Y; "
                  f"{[round(t, 1) for t in walls]} ms per call (the first "
                  f"builds the shard tables), local "
                  f"{[round(t, 1) for t in local_ms]} ms; launches per block "
                  f"{per_block} over {blocks} blocks, modmatmul_batched "
                  f"instances {inst}", flush=True)
            out["calls"][what] = {"ms": walls, "local_ms": local_ms,
                                  "launches": counts, "blocks": blocks,
                                  "per_block": per_block}
            if p == P_DEFAULT:
                device_share(torch, f"one sharded call, {what}",
                             lambda: sess.matmul(x, w, encoded=True),
                             "ring_fold", top=10)
            if p == P_DEFAULT and wire == "int32":
                out["ring"] = out["calls"][what]
                h = torch.randn((1, D_MODEL), generator=gen, device=dev,
                                dtype=torch.float64)
                hw = 0.02 * torch.randn((D_MODEL, VOCAB), generator=gen,
                                        device=dev, dtype=torch.float64)
                logits, ms = timed(sess, h, hw)
                hold_float(f"sharded float call ({what}, {ms:.1f} ms)",
                           logits, h, hw)
                del h, hw, logits
            del y, sess
        del local, y_local
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sharded phase: {out['phase_s']:.1f} s", flush=True)
    return out


def moe_phase(torch, np, dev, seed, hold_flash):
    """Serve olmoe-1b-7b at its published width and depth on the card,
    twice from one seed, with paged decode; holds the flash kernel at its
    D = 128 prefill shape on layer 0's real q, k, v.  Returns the flash
    kernel's record at that shape with its launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers
    from repro_torch.models import transformer as tr
    from repro_torch.serve import Engine

    t_phase = time.perf_counter()
    cfg = get_config("olmoe-1b-7b")
    require((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.vocab, cfg.moe.n_experts, cfg.moe.top_k,
             cfg.moe.d_ff_expert, cfg.dtype)
            == ("moe", 16, 2048, 16, 16, 128, 50304, 64, 8, 1024, "bfloat16"),
            f"olmoe-1b-7b config changed: {cfg}")
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    nbytes = sum(w.numel() * w.element_size() for w in params.parameters())
    print(f"moe: {cfg.name} at its published config ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
          f"{cfg.resolved_head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of width {cfg.moe.d_ff_expert}, vocab {cfg.vocab}, "
          f"{cfg.dtype}); {n_params / 1e9:.3f} B parameters, "
          f"{nbytes / 1e9:.3f} GB drawn from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    eng = Engine(cfg, params, block_size=SERVE_BLOCK)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, (1, t)) for t in MOE_PROMPTS]
    max_len = max(t + n - 1 for t, n in zip(MOE_PROMPTS, MOE_MAX_NEW,
                                            strict=True))

    def serve_once(what):
        sched = eng.make_scheduler(lanes=MOE_LANES, max_len=max_len)
        rids = [sched.submit(pr, n) for pr, n in zip(prompts, MOE_MAX_NEW,
                                                     strict=True)]
        decode = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain0 = flash_attention_plain.calls
        reset_launch_counts()
        t0 = time.perf_counter()
        more = True
        while more:
            lanes, prefills = sched.active(), sched.stats["prefills"]
            ts = time.perf_counter()
            more = sched.step()
            torch.cuda.synchronize()
            if sched.stats["prefills"] == prefills:
                decode.append((lanes, (time.perf_counter() - ts) * 1e3))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        inst = instance_counts()["flash_attention"]
        plain = flash_attention_plain.calls - plain0
        toks = [sched.finished[r] for r in rids]
        for r, n in zip(toks, MOE_MAX_NEW, strict=True):
            require(r.shape == (n,), f"moe {what}: {r.shape[0]} tokens, want {n}")
            require(bool(((r >= 0) & (r < cfg.vocab)).all()),
                    f"moe {what}: token outside the vocabulary")
        prefills = sched.stats["prefills"]
        require(prefills == len(MOE_PROMPTS), f"moe {what}: {prefills} prefills")
        require(counts["flash_attention"] == cfg.n_layers * prefills
                and sum(counts.values()) == counts["flash_attention"],
                f"moe {what}: launch counts {counts}")
        require(inst == {"wgmma": cfg.n_layers * prefills, "mma_sync": 0,
                         "cuda_core": 0}, f"moe {what}: flash instances {inst}")
        require(plain == 0, f"moe {what}: {plain} plain attention calls")
        require(sched.alloc.used_blocks() == 0, f"moe {what}: blocks still held")
        print(f"  {what}: {len(rids)} requests, {sum(MOE_MAX_NEW)} tokens in "
              f"{wall * 1e3:.1f} ms wall; {sched.stats['steps']} steps; "
              f"launches {counts}, flash instances {inst}, plain attention "
              f"calls {plain}", flush=True)
        return dict(toks=toks, counts=counts, wall=wall, decode=decode,
                    peak=torch.cuda.max_memory_allocated())

    print(f"moe: Engine on {eng.device}, scheduler with {MOE_LANES} lanes, "
          f"block size {SERVE_BLOCK}; prompts {list(MOE_PROMPTS)}, max_new "
          f"{list(MOE_MAX_NEW)}", flush=True)
    first = serve_once("run 1")
    second = serve_once("run 2 (same seed)")
    require(all(np.array_equal(x, y) for x, y in zip(first["toks"],
                                                     second["toks"], strict=True)),
            "moe: a second run from the same seed gave other tokens")
    print("  run 2 tokens equal run 1's", flush=True)

    by_len = {}
    for pr in prompts:
        tok = torch.as_tensor(pr, device=dev)
        if tok.shape[1] in by_len:
            continue
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.prefill(cfg, params, tok)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        by_len[tok.shape[1]] = min(runs)
    print("  prefill ms per prompt (host clock around a synchronised call, "
          "best of 2): " + ", ".join(f"T={t}: {ms:.2f}"
                                     for t, ms in sorted(by_len.items())),
          flush=True)
    dec = [ms for _, ms in second["decode"]]
    n_dec = sum(lanes for lanes, _ in second["decode"])
    experts = 3 * cfg.n_layers * cfg.moe.n_experts * cfg.d_model * 2 \
        * cfg.moe.d_ff_expert
    print(f"  decode (run 2, steps that admitted no request): {len(dec)} steps, "
          f"{sum(dec) / len(dec):.3f} ms mean, {min(dec):.3f} ms min per step "
          f"(up to {MOE_LANES} lanes); {n_dec} tokens in {sum(dec):.1f} ms; "
          f"expert weights read per step at least {experts / 1e9:.2f} GB "
          f"(every expert's buffer is computed)", flush=True)
    print(f"  weights {nbytes / 2**30:.3f} GiB; peak memory "
          f"{second['peak'] / 2**30:.3f} GiB (max_memory_allocated)", flush=True)

    tok0 = torch.as_tensor(prompts[0], device=dev)
    lp = params.layers[0]
    h = layers.rms_norm(params.embed[tok0], lp["attn_norm"], cfg.norm_eps)
    pos = torch.arange(tok0.shape[1], device=dev)[None]
    q, k, v = layers.gqa_project(h, lp, cfg, positions=pos)
    rec = hold_flash(f"olmoe layer 0's q, k, v of a {tok0.shape[1]}-token prompt",
                     q, k, v, iters=20, library=True, controls=True)
    require(rec["instance"] == "wgmma", f"moe flash instance {rec['instance']}")
    del q, k, v, h
    device_share(torch, f"moe prefill T={tok0.shape[1]}",
                 lambda: tr.prefill(cfg, params, tok0), "flash", top=10)
    sched = eng.make_scheduler(lanes=MOE_LANES, max_len=max_len)
    for pr in prompts[:MOE_LANES]:
        sched.submit(pr, 32)
    sched.step()
    device_share(torch, f"moe 4 decode steps, {MOE_LANES} lanes busy",
                 lambda: [sched.step() for _ in range(4)], "flash", top=6)
    del sched, eng, params
    torch.cuda.empty_cache()
    rec.update(launches=first["counts"]["flash_attention"],
               prefill_ms=by_len, decode_ms_mean=sum(dec) / len(dec),
               peak_gib=second["peak"] / 2**30,
               phase_s=time.perf_counter() - t_phase)
    print(f"moe phase: {rec['phase_s']:.1f} s", flush=True)
    return rec


def scan_faults(u, dt, a, b_t, c_t):
    """Two wrong results for the check against the plain version to
    reject, each made with the plain version: the decay dropped (a = 0),
    and b_t one step late."""
    import torch

    from repro_torch.kernels.selective_scan import selective_scan_plain

    yield "decay dropped (a = 0)", selective_scan_plain(
        u, dt, torch.zeros_like(a), b_t, c_t, return_state=True)
    late = torch.cat([torch.zeros_like(b_t[:, :1]), b_t[:, :-1]], dim=1)
    yield "b_t one step late", selective_scan_plain(u, dt, a, late, c_t,
                                                    return_state=True)


def scan_phase(torch, dev, gen, sms):
    """The selective-scan kernel against its plain version at jamba's
    widths (Di 8192, N 16), bf16 and fp32, on y and the final state: the
    routed ``tma`` instance and the ``simple`` one on the same operands,
    with two planted faults that must fail the check; both timed beside
    the plain version, the bytes bound and the special-function floor.
    Returns the records by (B, T)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.selective_scan import (
        agreement,
        selective_scan,
        selective_scan_plain,
    )

    print(f"selective_scan kernel checks (jamba-v0.1-52b: Di {SCAN_DI}, N "
          f"{SCAN_N}; dt = softplus(N(-4, 1)) as dt_bias -4 gives, a = "
          f"-(1..N), u, b, c ~ N(0, 1)); the tma instance routed, the simple "
          f"one beside it:", flush=True)
    rec = {}
    for b, t in SCAN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            def draw(*shape):
                return torch.randn(shape, generator=gen, device=dev)

            u = draw(b, t, SCAN_DI).to(dtype)
            dt = F.softplus(draw(b, t, SCAN_DI) - 4.0).to(dtype)
            a = -torch.arange(1, SCAN_N + 1, dtype=torch.float32,
                              device=dev).expand(SCAN_DI, SCAN_N).contiguous()
            b_t, c_t = draw(b, t, SCAN_N).to(dtype), draw(b, t, SCAN_N).to(dtype)
            ops = (u, dt, a, b_t, c_t)
            reset_launch_counts()
            y, h = selective_scan(*ops, return_state=True)
            torch.cuda.synchronize()
            require(launch_counts()["selective_scan"] == 1
                    and instance_counts()["selective_scan"]["tma"] == 1,
                    f"scan [{b},{t}]: instances "
                    f"{instance_counts()['selective_scan']}")
            want_y, want_h = selective_scan_plain(*ops, return_state=True)
            old_y, old_h = ss._launch(*ops, instance="simple",
                                      return_state=True)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            what = f"[{b},{t},{SCAN_DI},{SCAN_N}] {name}"
            for inst, (gy, gh) in (("tma", (y, h)), ("simple", (old_y, old_h))):
                require(gy.shape == want_y.shape and gh.shape == want_h.shape,
                        f"scan {what} {inst}: {tuple(gy.shape)} "
                        f"{tuple(gh.shape)}")
                require(bool(torch.isfinite(gy).all()
                             and torch.isfinite(gh).all()),
                        f"scan {what} {inst}: non-finite result")
            a_y, a_h = agreement(y, want_y), agreement(h, want_h)
            o_y, o_h = agreement(old_y, want_y), agreement(old_h, want_h)
            require(a_y["ok"] and a_h["ok"], f"scan {what}: tma != plain (y "
                    f"{readings(a_y)}; state {readings(a_h)})")
            require(o_y["ok"] and o_h["ok"], f"scan {what}: simple != plain "
                    f"(y {readings(o_y)}; state {readings(o_h)})")
            print(f"  {what}: tma y {readings(a_y)}; state {readings(a_h)}; "
                  f"simple y {readings(o_y)}; state {readings(o_h)}",
                  flush=True)
            del old_y, old_h
            served = dtype == torch.bfloat16
            if served and (b, t) == SCAN_SHAPES[1]:
                for fault, (bad_y, bad_h) in scan_faults(*ops):
                    f_y, f_h = agreement(bad_y, want_y), agreement(bad_h, want_h)
                    require(not f_y["ok"] and not f_h["ok"], f"scan {what}: the "
                            f"check accepts a planted fault ({fault}: y "
                            f"{readings(f_y)}; state {readings(f_h)})")
                    print(f"    control, {fault}: rejected (y {readings(f_y)}; "
                          f"state {readings(f_h)})", flush=True)
                    del bad_y, bad_h
            if served:
                nbytes, ops_n = scan_work(b, t, SCAN_DI, SCAN_N, 2)
                bms, by = bound(nbytes, ops_n, FP32_OPS_PER_S)
                exps = b * t * SCAN_DI * SCAN_N
                mufu_ms = exps / (MUFU_PER_SM_CLOCK * sms * SM_CLOCK_HZ) * 1e3
                r = rec[(b, t)] = {
                    "max_abs_err": max(a_y["max_abs_err"], a_h["max_abs_err"]),
                    "ms": time_ms(torch, lambda: selective_scan(
                        *ops, return_state=True), 20),
                    "simple_ms": time_ms(torch, lambda: ss._launch(
                        *ops, instance="simple", return_state=True), 20),
                    "plain_ms": time_ms(torch, lambda: selective_scan_plain(
                        *ops, return_state=True), 2),
                    "bound_ms": bms, "bound_by": by, "mufu_ms": mufu_ms,
                    "fp32_ops_ms": ops_n / FP32_OPS_PER_S * 1e3}
                print(f"    kernel [tma] {r['ms']:.4f} ms, simple "
                      f"{r['simple_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
                      f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB; "
                      f"{ops_n / 1e9:.2f} G fp32 operations take "
                      f"{r['fp32_ops_ms']:.4f} ms at the fp32 peak); "
                      f"{100 * bms / r['ms']:.1f} % of the bound; "
                      f"{exps / 1e9:.3f} G exponentials take {mufu_ms:.4f} ms "
                      f"on the special-function units ({MUFU_PER_SM_CLOCK} a "
                      f"clock per SM, {sms} SMs, {SM_CLOCK_HZ / 1e9} GHz)",
                      flush=True)
            del ops, u, dt, b_t, c_t, y, h, want_y, want_h
            torch.cuda.empty_cache()
    return rec


def serve_cli_phase(torch, dev, card):
    """``repro_torch.launch.serve.main`` on the card (its default device) at
    full width, each of ``SERVE_CLI_ARCHS`` twice with ``--batch 4
    --prompt-len 512 --max-new 16`` (whisper on the command line's 512
    zero frames): the same tokens both times, inside the vocab, equal to
    ``Engine.generate`` driven directly on the weights and prompt of the
    same seeds; the model's kernel launched in every run (counters zeroed
    just before it, read just after).  Prints each run's ``[serve]`` line
    beside the card; returns per arch the runs' tokens/s, the direct
    call's seconds and the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as cli
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Engine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    argv = ["--batch", str(SERVE_CLI_BATCH), "--prompt-len",
            str(SERVE_CLI_PROMPT), "--max-new", str(SERVE_CLI_NEW)]
    print(f"serve-CLI phase: python -m repro_torch.launch.serve "
          f"{' '.join(argv)} at full width, twice per arch ({card})",
          flush=True)
    out = {}
    for arch, kernel in SERVE_CLI_ARCHS:
        cfg = get_config(arch)
        runs = []
        for i in range(2):
            torch.cuda.synchronize()
            reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                toks = cli.main(["--arch", arch, *argv])
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            line = buf.getvalue().strip()
            print(f"  {arch} run {i + 1} ({card}): {line}; launches {counts}",
                  flush=True)
            rate = re.search(r"\(([0-9.]+) tok/s\)", line)
            require(rate is not None, f"{arch}: no [serve] line: {line!r}")
            require(counts.get(kernel, 0) > 0,
                    f"{arch}: the CLI's run launched no {kernel} ({counts})")
            require(toks.is_cuda and tuple(toks.shape)
                    == (SERVE_CLI_BATCH, SERVE_CLI_NEW),
                    f"{arch}: tokens {tuple(toks.shape)} on {toks.device}")
            require(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab,
                    f"{arch}: a token outside the vocab {cfg.vocab}")
            runs.append((toks, float(rate.group(1)), counts))
        require(torch.equal(runs[0][0], runs[1][0]),
                f"{arch}: the CLI's two runs gave different tokens")
        params, prompt, embeds = cli.inputs(cfg, SERVE_CLI_BATCH,
                                            SERVE_CLI_PROMPT, dev)
        t0 = time.perf_counter()
        direct = Engine(cfg, params, device=dev).generate(
            prompt, SERVE_CLI_NEW, embeds=embeds)
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        require(torch.equal(direct, runs[0][0]),
                f"{arch}: Engine.generate on the same seeds != the CLI's tokens")
        print(f"  {arch}: the same tokens twice and from Engine.generate "
              f"driven directly ({direct_s:.4f} s, "
              f"{SERVE_CLI_BATCH * SERVE_CLI_NEW / direct_s:.1f} tok/s; {card})",
              flush=True)
        out[arch] = {"cli_tok_s": [r[1] for r in runs],
                     "direct_s": direct_s, "launches": runs[0][2]}
        del params, prompt, embeds, direct, runs
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"serve-CLI phase: {phase_s:.1f} s", flush=True)
    return dict(out, phase_s=phase_s, card=card)


def timed_prefill_decode(torch, model, cfg, params, tok, embeds=None, steps=8):
    """Prefill ``tok`` (best of 2, host clock around a synchronised call),
    then ``steps`` decode steps from its cache; returns (prefill ms, decode
    ms per step)."""
    from repro_torch.serve.engine import _pad_cache

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(cfg, params, tok, embeds=embeds)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    cache = _pad_cache(cache, steps)
    nxt = logits[:, -1:].argmax(-1)
    t = tok.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(cfg, params, cache, nxt, t + i)
        nxt = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    return min(runs), (time.perf_counter() - t0) * 1e3 / steps


def serve_legacy(torch, np, what, eng, prompts, calls, per_prefill, embeds=()):
    """``Engine.generate`` over ``calls`` ((batch, prompt, max_new)) on the
    card, with the launch counters zeroed just before: each prefill must
    launch ``per_prefill`` ({wrapper: launches}) and nothing else, with no
    plain attention or plain scan call, the flash launches all in the
    wgmma instance.  Returns (tokens, counts, walls, peak bytes)."""
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.selective_scan import selective_scan_plain

    vocab = eng.cfg.vocab
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain0 = flash_attention_plain.calls + selective_scan_plain.calls
    reset_launch_counts()
    toks, walls = [], []
    for i, (pr, (b, t, n)) in enumerate(zip(prompts, calls, strict=True)):
        t0 = time.perf_counter()
        out = eng.generate(pr, n, embeds=embeds[i] if embeds else None)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        want = {k: v * (i + 1) for k, v in per_prefill.items()}
        require({k: counts[k] for k in want} == want
                and sum(counts.values()) == sum(want.values()),
                f"{what}: launches {counts} after {i + 1} prefills, want {want}")
        out = out.cpu().numpy()
        require(out.shape == (b, n), f"{what}: tokens {out.shape}")
        require(bool(((out >= 0) & (out < vocab)).all()),
                f"{what}: token outside the vocabulary")
        toks.append(out)
    counts = launch_counts()
    inst = instance_counts()["flash_attention"]
    plain = flash_attention_plain.calls + selective_scan_plain.calls - plain0
    require(inst["wgmma"] == counts["flash_attention"],
            f"{what}: flash instances {inst}")
    require(plain == 0, f"{what}: {plain} plain attention or scan calls")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {what}: generate " + ", ".join(
        f"[{b},{t}] + {n}: {w:.1f} ms wall" for (b, t, n), w in
        zip(calls, walls, strict=True)) + f"; launches {counts}, flash "
        f"instances {inst}, plain attention or scan calls {plain}; peak memory "
        f"{peak / 2**30:.3f} GiB", flush=True)
    return toks, counts, walls, peak


def jamba_phase(torch, np, dev, seed, hold_flash):
    """Serve jamba-v0.1-52b at its published width, cut to one period of
    its interleave (8 layers), twice on the same weights; hold the flash
    kernel on layer 4's real q, k, v; check in fp32 at 5 layers that the
    states prefill hands to decode are a longer prefill's.  Returns the
    flash record at layer 4's shape with the serve run's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import jamba as jb
    from repro_torch.models.layers import gqa_project, rms_norm
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import _pad_cache

    t_phase = time.perf_counter()
    full = get_config("jamba-v0.1-52b")
    require((full.family, full.n_layers, full.d_model, full.n_heads,
             full.n_kv_heads, full.resolved_head_dim, full.d_ff, full.vocab,
             full.moe.n_experts, full.moe.top_k, full.moe.d_ff_expert,
             full.ssm.d_state, full.ssm.expand, full.ssm.d_conv,
             full.attn_every, full.attn_offset, full.dtype)
            == ("hybrid", 32, 4096, 32, 8, 128, 14336, 65536, 16, 2, 14336,
                SCAN_N, 2, 4, 8, 4, "bfloat16"),
            f"jamba-v0.1-52b config changed: {full}")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    attn = [l for l in range(cfg.n_layers) if jb.is_attn_layer(cfg, l)]
    n_mamba = cfg.n_layers - len(attn)
    require(attn == [4] and n_mamba == 7, f"jamba interleave {attn}")
    t0 = time.perf_counter()
    params = jb.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    nbytes = sum(w.numel() * w.element_size() for w in params.parameters())
    print(f"jamba: {cfg.name} at its published width (d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
          f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}, d_state {cfg.ssm.d_state}, expand "
          f"{cfg.ssm.expand}, d_conv {cfg.ssm.d_conv}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), {cfg.n_layers} of its {full.n_layers} layers (one "
          f"period: attention at layer {attn[0]}, MoE on the odd layers); "
          f"{n_params / 1e9:.3f} B parameters, {nbytes / 1e9:.3f} GB drawn from "
          f"seed {seed} in {time.perf_counter() - t0:.2f} s", flush=True)
    eng = Engine(cfg, params, device=dev)
    require(eng.device.type == dev.type and not eng._paged,
            f"jamba engine on {eng.device}, paged {eng._paged}")
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab, (b, t)) for b, t, _ in JAMBA_CALLS]
    per_prefill = {"flash_attention": len(attn), "selective_scan": n_mamba}
    first = serve_legacy(torch, np, "run 1", eng, prompts, JAMBA_CALLS,
                         per_prefill)
    second = serve_legacy(torch, np, "run 2 (same weights)", eng, prompts,
                          JAMBA_CALLS, per_prefill)
    require(all(np.array_equal(x, y) for x, y in zip(first[0], second[0],
                                                     strict=True)),
            "jamba: a second run gave other tokens")
    print("  run 2 tokens equal run 1's", flush=True)
    times = {}
    for pr in prompts:
        tok = torch.as_tensor(pr, device=dev)
        times[tuple(tok.shape)] = timed_prefill_decode(torch, jb, cfg, params,
                                                       tok)
        print(f"  [{tok.shape[0]},{tok.shape[1]}]: prefill "
              f"{times[tuple(tok.shape)][0]:.2f} ms (best of 2), decode "
              f"{times[tuple(tok.shape)][1]:.2f} ms per step over 8 steps; "
              f"the weight-read floor is {nbytes / HBM_BYTES_PER_S * 1e3:.2f} "
              f"ms a step (every expert's buffer is computed)", flush=True)
    tok0 = torch.as_tensor(prompts[0], device=dev)
    device_share(torch, f"jamba prefill [1,{tok0.shape[1]}]",
                 lambda: jb.prefill(cfg, params, tok0), "scan", top=8)
    _, cache = jb.prefill(cfg, params, tok0)
    cache = _pad_cache(cache, 4)
    nxt = tok0[:, -1:]
    device_share(torch, "jamba 4 decode steps at batch 1",
                 lambda: [jb.decode_step(cfg, params, cache, nxt,
                                         tok0.shape[1] + i) for i in range(4)],
                 "flash", top=6)
    del cache

    # the flash kernel on the q, k, v that layer 4 makes of the first prompt
    x = params.embed[tok0]
    pos = torch.arange(tok0.shape[1], device=dev)[None]
    for l in range(attn[0]):
        p = params.layers[l]
        x = x + jb._mix(cfg, l, x, p, pos)[0]
        x = x + jb._ffn(cfg, l, x, p)[0]
    p4 = params.layers[attn[0]]
    q, k, v = gqa_project(rms_norm(x, p4["pre_norm"], cfg.norm_eps), p4, cfg,
                          positions=pos)
    rec = hold_flash(f"jamba layer {attn[0]}'s q, k, v of a "
                     f"{tok0.shape[1]}-token prompt", q, k, v, iters=20,
                     library=True, controls=True)
    require(rec["instance"] == "wgmma", f"jamba flash instance {rec['instance']}")
    del q, k, v, x, p, p4, eng, params
    torch.cuda.empty_cache()

    # the states prefill hands to decode, in fp32 at full width: decode one
    # step from a prefill of T - 1 tokens against a prefill of T; zeroed
    # conv and ssm states must fail the same check.  Five layers hold layer
    # 4's attention; the MoE keeps every pick (capacity E / k), since a
    # prefill at 1.25 may drop the last token's pick where a one-token
    # decode step never does
    cfg32 = dataclasses.replace(
        cfg, n_layers=JAMBA_STATE_LAYERS, dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k))
    p32 = jb.init_params(cfg32, seed, device=dev)
    n32 = sum(w.numel() for w in p32.parameters())
    tok = torch.as_tensor(prompts[1][:1], device=dev)
    want, _ = jb.prefill(cfg32, p32, tok)

    def from_state(what, zero):
        _, cache = jb.prefill(cfg32, p32, tok[:, :-1])
        if zero:
            for s in cache.conv + cache.ssm:
                if s is not None:
                    s.zero_()
        got, _ = jb.decode_step(cfg32, p32, _pad_cache(cache, 1), tok[:, -1:],
                                tok.shape[1] - 1)
        rms = float(want.float().pow(2).mean().sqrt())
        diff = float((got - want).abs().max())
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        print(f"  {what}: next-token logits max |diff| {diff:.3e} = "
              f"{diff / rms:.3e} of their rms (limit {STATE_TOL:g}); greedy "
              f"tokens {'equal' if same else 'differ'}", flush=True)
        return diff <= STATE_TOL * rms and same

    print(f"  fp32 state check: {cfg32.n_layers} layers at full width, "
          f"{n32 / 1e9:.3f} B parameters ({4 * n32 / 1e9:.2f} GB)", flush=True)
    require(from_state(f"decode from a prefill of {tok.shape[1] - 1} tokens vs "
                       f"a prefill of {tok.shape[1]} (fp32)", False),
            "jamba: the states handed to decode disagree with a longer prefill")
    require(not from_state("control, decode from zeroed conv and ssm states",
                           True),
            "jamba: the state check accepts zeroed conv and ssm states")
    del p32, want
    torch.cuda.empty_cache()
    rec.update(launches=first[1]["flash_attention"],
               scan_launches=first[1]["selective_scan"],
               times={f"{b}x{t}": ms for (b, t), ms in times.items()},
               peak_gib=second[3] / 2**30, n_params=n_params,
               phase_s=time.perf_counter() - t_phase)
    print(f"jamba phase: {rec['phase_s']:.1f} s", flush=True)
    return rec


def whisper_phase(torch, np, dev, seed, hold_flash):
    """Serve whisper-small at full width and depth, twice on the same
    weights and frames; hold the flash kernel at the encoder's and the
    cross-attention's shapes beside SDPA.  Returns the two flash records
    and the serve run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instance_counts, reset_launch_counts
    from repro_torch.models import whisper as wh
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import _pad_cache

    t_phase = time.perf_counter()
    cfg = get_config("whisper-small")
    require((cfg.family, cfg.n_layers, cfg.n_enc_layers, cfg.d_model,
             cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab,
             cfg.padded_vocab(), cfg.dtype)
            == ("encdec", 12, 12, 768, 12, 64, 3072, 51865, 51968, "bfloat16"),
            f"whisper-small config changed: {cfg}")
    t0 = time.perf_counter()
    params = wh.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    print(f"whisper: {cfg.name} at its published config ({cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
          f"{cfg.padded_vocab()}, {cfg.dtype}); {n_params / 1e9:.3f} B "
          f"parameters ({params.dec_pos.numel() / 1e6:.1f} M of them the "
          f"decoder's {params.dec_pos.shape[0]} learned positions) drawn from "
          f"seed {seed} in {time.perf_counter() - t0:.2f} s", flush=True)
    eng = Engine(cfg, params, device=dev)
    require(eng.device.type == dev.type and not eng._paged,
            f"whisper engine on {eng.device}, paged {eng._paged}")
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab, (b, t)) for b, t, _ in WHISPER_CALLS]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    frames = [torch.randn((b, WHISPER_FRAMES, cfg.d_model), generator=gen,
                          device=dev).to(params.embed.dtype)
              for b, _, _ in WHISPER_CALLS]
    per_prefill = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers}
    print(f"  Engine.generate {list(WHISPER_CALLS)} (batch, prompt, max_new), "
          f"{WHISPER_FRAMES} stub frames a request (30 s of audio after the "
          f"conv frontend), drawn from seed {seed + 3}", flush=True)
    first = serve_legacy(torch, np, "run 1", eng, prompts, WHISPER_CALLS,
                         per_prefill, frames)
    second = serve_legacy(torch, np, "run 2 (same weights)", eng, prompts,
                          WHISPER_CALLS, per_prefill, frames)
    require(all(np.array_equal(x, y) for x, y in zip(first[0], second[0],
                                                     strict=True)),
            "whisper: a second run gave other tokens")
    print("  run 2 tokens equal run 1's", flush=True)
    times = {}
    for pr, fr in zip(prompts, frames, strict=True):
        tok = torch.as_tensor(pr, device=dev)
        times[tuple(tok.shape)] = timed_prefill_decode(torch, wh, cfg, params,
                                                       tok, fr)
        print(f"  [{tok.shape[0]},{tok.shape[1]}] + {WHISPER_FRAMES} frames: "
              f"prefill {times[tuple(tok.shape)][0]:.2f} ms (best of 2, the "
              f"encoder included), decode {times[tuple(tok.shape)][1]:.2f} ms "
              f"per step over 8 steps", flush=True)
    tok0 = torch.as_tensor(prompts[0], device=dev)
    device_share(torch, f"whisper prefill [{tok0.shape[0]},{tok0.shape[1]}] + "
                 f"{WHISPER_FRAMES} frames",
                 lambda: wh.prefill(cfg, params, tok0, embeds=frames[0]),
                 "flash", top=8)
    _, cache = wh.prefill(cfg, params, tok0, embeds=frames[0])
    cache = _pad_cache(cache, 4)
    device_share(torch, f"whisper 4 decode steps at batch {tok0.shape[0]}",
                 lambda: [wh.decode_step(cfg, params, cache, tok0[:, -1:],
                                         tok0.shape[1] + i) for i in range(4)],
                 "flash", top=6)
    del cache

    # the kernel on encoder layer 0's real q, k, v of one request's frames
    fr = frames[0][:1]
    p0 = params.enc_layers[0]
    x = fr + wh.sinusoids(WHISPER_FRAMES, cfg.d_model, device=dev).to(fr.dtype)
    h = wh.layer_norm(x, p0["norm1"]["scale"], p0["norm1"]["bias"], cfg.norm_eps)
    q, k, v = (wh._heads(cfg, h @ p0[name]) for name in ("w_q", "w_k", "w_v"))
    enc = hold_flash(f"whisper encoder layer 0's q, k, v [1,{WHISPER_FRAMES},"
                     f"{cfg.n_heads},{cfg.resolved_head_dim}] (non-causal)",
                     q, k, v, causal=False, iters=20, library=True,
                     controls=True)
    # the cross shape: the longest prompt's queries against the frames' keys
    t_x = max(t for _, t, _ in WHISPER_CALLS)
    qx = torch.randn((1, t_x, cfg.n_heads, cfg.resolved_head_dim),
                     generator=gen, device=dev).to(q.dtype)
    cross = hold_flash(f"whisper cross-attention [1,{t_x},{cfg.n_heads},"
                       f"{cfg.resolved_head_dim}] x [1,{WHISPER_FRAMES},"
                       f"{cfg.n_heads},{cfg.resolved_head_dim}] (non-causal)",
                       qx, k, v, causal=False, iters=20, library=True)
    for r in (enc, cross):
        require(r["instance"] == "wgmma", f"whisper flash instance "
                f"{r['instance']}")

    # the bf16 model on fp32 frames, as JAX promotes: the encoder in fp32,
    # the cross-attention's fp32 keys and values against bf16 queries on
    # the fp32 kernel, a bf16 hidden state (the CPU test pins these dtypes
    # to JAX's)
    fr32 = torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=gen,
                       device=dev)
    tok32 = torch.as_tensor(prompts[1][:1], device=dev)
    reset_launch_counts()
    enc32 = wh.encode(cfg, params, fr32)
    hid32, _ = wh.forward(cfg, params, tok32, embeds=fr32)
    torch.cuda.synchronize()
    inst32 = instance_counts()["flash_attention"]
    want32 = {"wgmma": cfg.n_layers, "mma_sync": 0,
              "cuda_core": 2 * cfg.n_enc_layers + cfg.n_layers}
    require(enc32.dtype == torch.float32 and hid32.dtype == torch.bfloat16
            and tuple(hid32.shape) == (1, tok32.shape[1], cfg.d_model)
            and bool(torch.isfinite(enc32).all())
            and bool(torch.isfinite(hid32.float()).all()),
            f"whisper on fp32 frames: encode {enc32.dtype}, forward "
            f"{hid32.dtype} {tuple(hid32.shape)}")
    require(inst32 == want32, f"whisper on fp32 frames: flash instances "
            f"{inst32}, want {want32}")
    print(f"  bf16 weights on fp32 frames [1,{WHISPER_FRAMES},{cfg.d_model}], "
          f"{tok32.shape[1]} tokens: encode {enc32.dtype}, forward's hidden "
          f"state {hid32.dtype}, finite; flash instances {inst32} (encoder "
          f"and cross-attention in fp32)", flush=True)
    del fr32, enc32, hid32
    del q, k, v, qx, h, x, eng, params
    torch.cuda.empty_cache()
    out = {"launches": first[1]["flash_attention"], "encoder": enc,
           "cross": cross, "cross_t": t_x,
           "times": {f"{b}x{t}": ms for (b, t), ms in times.items()},
           "peak_gib": second[3] / 2**30, "n_params": n_params,
           "phase_s": time.perf_counter() - t_phase}
    print(f"whisper phase: {out['phase_s']:.1f} s", flush=True)
    return out


# the flash-backward phase: (what, B, T, S, Hq, Hkv, D, dtype, causal,
# q_offset, timed): llama3.2-1b's training shape, olmoe's and jamba's
# D = 128, whisper-small's encoder, decoder-self and cross shapes at its
# training batch, one fp32 shape and rows that see no key
BWD_CASES = (
    ("llama3.2-1b train", 4, 2048, 2048, 32, 8, 64, "bfloat16", True, 0, True),
    ("olmoe-1b-7b D = 128", 1, 2048, 2048, 16, 16, 128, "bfloat16", True, 0,
     True),
    ("jamba D = 128, GQA 4", 1, 2048, 2048, 32, 8, 128, "bfloat16", True, 0,
     False),
    ("whisper encoder", 8, 1500, 1500, 12, 12, 64, "bfloat16", False, 0, True),
    ("whisper decoder self", 8, 448, 448, 12, 12, 64, "bfloat16", True, 0,
     False),
    ("whisper cross", 8, 448, 1500, 12, 12, 64, "bfloat16", False, 0, True),
    ("fp32", 1, 512, 512, 8, 2, 64, "float32", True, 0, True),
    ("rows that see no key", 1, 256, 256, 8, 2, 64, "bfloat16", True, -64,
     False),
)
# the train phase: llama3.2-1b at full width and depth, a repeated batch of
# TRAIN_BATCH x TRAIN_SEQ tokens for TRAIN_STEPS steps; the last loss must
# be below the first by TRAIN_DROP (PERF.md states the margin before the
# run); the resume check at full width cut to RESUME_LAYERS layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_DROP = 4, 2048, 8, 1.0
RESUME_LAYERS, RESUME_STEPS = 2, 4
# a resumed run's losses against the uninterrupted run's, relative (the
# restored state is bit-exact; the margin covers library kernels that may
# sum in another order from one process to the next)
RESUME_TOL = 1e-3
# the fp32 two-layer cut, kernels against flash_attention_plain under
# autograd: loss and every gradient leaf in relative Frobenius norm (fp32
# sums in another order through two layers and the tied 128256-wide head)
CUT_TOL = 1e-4
# whisper-small training: batch, tokens, frames, steps
WHISPER_TRAIN = (8, 448, 1500, 3)


def bwd_faults(q, k, v, o, do, lse, ref, causal, q_offset):
    """Three wrong backwards for ``grad_agreement`` to reject, made with the
    plain version: D omitted (O = 0 makes D = rowsum(dO o O) = 0), the scale
    dropped from dK, and each kv-head's gradients from its group's first
    q-head only (when there is a group)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    kw = dict(causal=causal, q_offset=q_offset)
    yield "D omitted", flash_attention_bwd_plain(q, k, v, torch.zeros_like(o),
                                                 do, lse, **kw)
    yield "scale dropped from dK", (ref[0], ref[1] * q.shape[-1] ** 0.5, ref[2])
    group = q.shape[2] // k.shape[2]
    if group > 1:
        _, dk1, dv1 = flash_attention_bwd_plain(
            q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2), o,
            do, lse, **kw)
        yield "GQA sum over one head", (ref[0], dk1[:, :, ::group],
                                        dv1[:, :, ::group])


def bwd_readings(a):
    """One line of a ``grad_agreement`` record (flash, WKV-6 or the scan)."""
    return "; ".join(f"{n} worst {r['worst']:.3f}, rel. Frobenius "
                     f"{r['rel_frob']:.2e}" for n, r in a.items() if n != "ok")


def flash_bwd_phase(torch, dev, gen):
    """Hold the flash backward kernel against its plain version at every
    training shape, with the planted faults; time it beside the plain
    version, SDPA's backward (the yardstick) and the bound.  Returns a
    record per case."""
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    print("flash_attention_bwd kernel checks (grad_agreement: fp32 1e-5 "
          "relative Frobenius per gradient, bf16 2^-7; per element 1e-4 / "
          "2^-6 of |ref| + row rms + 0.1 x the gradient's rms):", flush=True)
    out = {}
    for (what, b, t, s, hq, hkv, d, dt, causal, q_offset, timed) in BWD_CASES:
        dtype = getattr(torch, dt)

        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, k, v, do = draw(b, t, hq, d), draw(b, s, hkv, d), draw(b, s, hkv, d), \
            draw(b, t, hq, d)
        kw = dict(causal=causal, q_offset=q_offset)
        lse = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
        o = fa._launch(q, k, v, instance=fa.choose_instance(q, k, v), lse=lse,
                       **kw)
        reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        # every case is aligned bf16 at D 64 or 128 (wgmma) or fp32
        inst = "wgmma" if dtype == torch.bfloat16 else "cuda_core"
        require(fa.choose_bwd_instance(q, k, v) == inst
                and launch_counts()["flash_attention_bwd"] == 1
                and instance_counts()["flash_attention_bwd"][inst] == 1,
                f"{what}: backward launches {launch_counts()}, instances "
                f"{instance_counts()['flash_attention_bwd']}, want {inst}")
        ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
        require(all(bool(torch.isfinite(g).all()) for g in got),
                f"{what}: non-finite gradient")
        agree = fa.grad_agreement(got, ref)
        require(agree["ok"], f"{what}: kernel != plain ({bwd_readings(agree)})")
        if q_offset < 0:
            require(not got[0][:, :-q_offset].any(),
                    f"{what}: rows that see no key have nonzero dq")
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        require(all(torch.equal(x, y) for x, y in zip(got, again, strict=True)),
                f"{what}: a second launch gave other bits")
        shape = (f"{dt} {'causal' if causal else 'non-causal'} q [{b},{t},{hq},"
                 f"{d}], k and v [{b},{s},{hkv},{d}]"
                 + (f", q_offset {q_offset}" if q_offset else ""))
        print(f"  {what} {shape} [{inst}]: {bwd_readings(agree)}; the same "
              f"bits twice", flush=True)
        for fault, bad in bwd_faults(q, k, v, o, do, lse, ref, causal,
                                     q_offset):
            a = fa.grad_agreement(bad, ref)
            require(not a["ok"], f"{what}: the check accepts a planted fault "
                    f"({fault}: {bwd_readings(a)})")
            worst = max(a[n]["rel_frob"] for n in fa.GRAD_NAMES)
            print(f"    control, {fault}: rejected (worst rel. Frobenius "
                  f"{worst:.3e})", flush=True)
        nbytes, flops, peak = bwd_work(q, k, causal, q_offset)
        bms, by = bound(nbytes, flops, peak)
        rec = {"shape": shape, "instance": inst, "bound_ms": bms,
               "bound_by": by, "max_abs_err": max(agree[n]["max_abs_err"]
                                                  for n in fa.GRAD_NAMES),
               "rel_frob": {n: agree[n]["rel_frob"] for n in fa.GRAD_NAMES}}
        if timed:
            rec["ms"] = time_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, do, lse, **kw), 10)
            rec["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, **kw), 2)
            if inst == "wgmma":
                # the earlier instance on the same operands, held and timed
                # in the same call (uncounted)
                old = fa._bwd_launch(q, k, v, o, do, lse, instance="mma_sync",
                                     **kw)
                a_old = fa.grad_agreement(old, ref)
                require(a_old["ok"], f"{what}: mma_sync != plain "
                        f"({bwd_readings(a_old)})")
                rec["mma_sync_ms"] = time_ms(torch, lambda: fa._bwd_launch(
                    q, k, v, o, do, lse, instance="mma_sync", **kw), 10)
                del old
            if q_offset == 0:
                # SDPA's backward on the same q and dO, k and v repeated to
                # the q-heads outside the timing (its GQA backward may not
                # take the fused kernels): the kernel's work, head for head
                group = hq // hkv
                qs, ks, vs = (x.detach().transpose(1, 2).contiguous()
                              .requires_grad_() for x in (
                                  q, k.repeat_interleave(group, 2),
                                  v.repeat_interleave(group, 2)))
                lib_out = torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal)
                lib_do = do.transpose(1, 2).contiguous()
                rec["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (qs, ks, vs), lib_do, retain_graph=True), 10)
                del qs, ks, vs, lib_out, lib_do
            else:
                rec["library_ms"] = None
            lib = (f", SDPA backward {rec['library_ms']:.4f} ms"
                   if rec["library_ms"] is not None else "")
            if "mma_sync_ms" in rec:
                lib += f", mma_sync {rec['mma_sync_ms']:.4f} ms"
            print(f"    kernel [{inst}] {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms{lib}, bound {bms:.4f} ms ({by}: "
                  f"{flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB): {100 * bms / rec['ms']:.1f} % of the "
                  f"bound", flush=True)
        out[what] = rec
        del q, k, v, do, o, lse, got, ref, again
        torch.cuda.empty_cache()
    print(f"flash backward phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# the recurrent-backward phase.  WKV-6: (what, B, T, H, dtype, w mean, start
# and final state gradients, timed): rwkv6-1.6b's training microbatch (4 x
# 2048 tokens in 2), fp32 with fast decay, a ragged T.  The scan: (what, B,
# T, dtype, dt mean, final state gradient, timed) at jamba's Di and N, u and
# b, c as the views the model hands over: jamba's training microbatch (4 x
# 2048 in 4), fp32, a ragged T over two rows
RWKV_BWD_CASES = (
    ("rwkv6-1.6b train microbatch", 2, 2048, 32, "bfloat16", -6.0, False,
     True),
    ("fp32, w ~ N(0, 1), state0 and dstate", 2, 2048, 32, "float32", 0.0,
     True, False),
    ("ragged T, state0 and dstate", 1, 1000, 32, "bfloat16", -6.0, True,
     False),
)
SCAN_BWD_CASES = (
    ("jamba train microbatch", 1, 2048, "bfloat16", -4.0, False, True),
    ("fp32 with dstate", 1, 2048, "float32", -4.0, True, False),
    ("ragged T, two rows, dt ~ softplus(N(0, 1))", 2, 1000, "bfloat16", 0.0,
     True, False),
)
# the recurrent families' training: rwkv6-1.6b at full width and depth for
# RWKV_TRAIN_STEPS, jamba-v0.1-52b at full width cut to JAMBA_TRAIN_LAYERS
# layers for JAMBA_TRAIN_STEPS, each on one repeated TRAIN_BATCH x TRAIN_SEQ
# batch in its ARCH_TRAIN_OVERRIDES microbatches; the last loss must be below
# the first by the margin (PERF.md states both before the run)
RWKV_TRAIN_STEPS, RWKV_TRAIN_DROP = 8, 1.0
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_STEPS, JAMBA_TRAIN_DROP = 2, 6, 0.5
# the reduced fp32 recurrent families, card against CPU: every gradient
# leaf, and one step's loss, gnorm and updated weights, in relative
# Frobenius norm
STEP_TOL = 1e-5


def wkv_chunked_work(b, t, h, elem_bytes):
    """(bytes, TF32 flops) of the chunked instance's own work at K = V = 64
    and chunks of 64: the function's bytes (:func:`wkv_bwd_work`) plus its
    fp32 scratch, each written once and read once: the chunks' products
    (both roles) and the chunk states S and G; its wgmma products per
    chunk: the chunk products (64^3, the G role three times over for
    3xTF32), A = dout v^T (64^3), the sub-chunk states (6 of 64 x 64 x 16)
    and the state terms of dr, dk, dv (12 of 64 x 16 x 64)."""
    nbytes, _ = wkv_bwd_work(b, t, h, elem_bytes)
    n = -(-t // 64)
    nbytes += 2 * 4 * 4 * b * n * h * RWKV_HEAD * RWKV_HEAD
    macs = (64 ** 3 + 3 * 64 ** 3 + 64 ** 3
            + 6 * 64 * 64 * 16 + 12 * 64 * 16 * 64)
    return nbytes, 2 * macs * b * n * h


def wkv_grad_ref(torch, ops, s0, dout, ds):
    """torch.autograd.grad of ``rwkv6_plain`` on the same operands: (dr,
    dk, dv, dw, du, dstate0 or None)."""
    from repro_torch.kernels.rwkv6 import rwkv6_plain

    leaves = [x.detach().clone().requires_grad_() for x in ops]
    if s0 is not None:
        leaves.append(s0.detach().clone().requires_grad_())
    out, state = rwkv6_plain(*leaves[:5], state0=leaves[5] if s0 is not None
                             else None)
    loss = (out * dout).sum() + (0 if ds is None else (state * ds).sum())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads, strict=True)]
    return tuple(grads) + ((None,) if s0 is None else ())


def scan_grad_ref(torch, ops, dy, ds):
    """torch.autograd.grad of ``selective_scan_plain`` on the same
    operands: (du, ddt, da, db, dc)."""
    from repro_torch.kernels.selective_scan import selective_scan_plain

    leaves = [x.detach().clone().requires_grad_() for x in ops]
    y, state = selective_scan_plain(*leaves, return_state=True)
    loss = (y * dy).sum() + (0 if ds is None else (state * ds).sum())
    return torch.autograd.grad(loss, leaves)


def wkv_bwd_faults(ops, dout, got):
    """Three wrong backwards for ``grad_agreement`` to reject: dw's sign
    flipped on the last tile, du with head 0 dropped, and the reverse sweep
    starting one step late (dk, dv and dw of the plain backward with the
    last step's dout left out)."""
    from repro_torch.kernels.rwkv6 import BWD_TILE, rwkv6_bwd_plain

    dw = got[3].clone()
    dw[:, -BWD_TILE:] *= -1
    yield "dw's sign flipped on the last tile", got[:3] + (dw,) + got[4:]
    du = got[4].clone()
    du[0] = 0
    yield "du with head 0 dropped", got[:4] + (du,) + got[5:]
    late = dout.clone()
    late[:, -1] = 0
    bad = rwkv6_bwd_plain(*ops, late)
    yield "the reverse sweep one step late", (got[0],) + bad[1:4] + got[4:]


@contextlib.contextmanager
def planted(module, name, fn):
    """``module.name`` replaced by ``fn`` for the block: a fault planted in
    a plain version's arithmetic, for the checks to reject."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def wkv_chunked_faults(ops, dout):
    """Two wrong backwards in the chunked instance's arithmetic (its plain
    version, planted): each chunk handed the start state of the chunk
    before it, and the sums of log-decay before and after each step of a
    sub-chunk swapped (every gate referenced to the sub-chunk's wrong
    end)."""
    from repro_torch.kernels import rwkv6 as wk

    scan, sums = wk._chunk_scan, wk._gate_sums

    def shifted(tot, x, init, *, reverse=False):
        states, last = scan(tot, x, init, reverse=reverse)
        return (states if reverse else states[:1] + states[:-1]), last

    for what, name, fn in (
            ("a chunk state from the wrong chunk", "_chunk_scan", shifted),
            ("a gate referenced to the wrong sub-chunk", "_gate_sums",
             lambda lq: sums(lq)[::-1])):
        with planted(wk, name, fn):
            bad = wk.rwkv6_bwd_chunked_plain(*ops, dout)
        yield what, bad


def scan_bwd_faults(ops, dy, hck, got):
    """Three wrong backwards for ``grad_agreement`` to reject: the kernel fed
    the checkpoints one stretch off (h_{t-1} from the wrong tile), db
    without the first block's partial (its 32 channels' share, from the
    plain backward), and G's chain with the kept e_t one step off (the
    plain backward's planted fault)."""
    from repro_torch.kernels import selective_scan as ss

    yield "h_{t-1} read from the wrong tile", ss.selective_scan_bwd(
        *ops, dy, checkpoints=hck.roll(1, dims=1).contiguous())
    with planted(ss, "_next_decay", lambda e: e):
        bad = ss.selective_scan_bwd_plain(*ops, dy)
    yield "e_t one step off in G's chain", bad
    u, dt, a, b_t, c_t = ops
    first = ss.selective_scan_bwd_plain(u[..., :32], dt[..., :32], a[:32], b_t,
                                        c_t, dy[..., :32])
    db = (got[3].float() - first[3].float()).to(got[3].dtype)
    yield "db without one block's partial", got[:3] + (db, got[4])


def interleaved_ms(torch, fns, order, iters):
    """Each of ``fns`` (name: call) timed by :func:`graph_ms` in ``order``
    (one name after another, e.g. old, new, new, old, so that a drift of
    the card's clock falls on both); the least time of each name."""
    times = {}
    for name in order:
        times.setdefault(name, []).append(graph_ms(torch, fns[name], iters))
    return {name: min(t) for name, t in times.items()}


def recurrent_bwd_phase(torch, dev, gen, sms):
    """Hold ``rwkv6_bwd`` and ``selective_scan_bwd`` against
    ``torch.autograd.grad`` of their plain forwards at the training shapes,
    each instance (the routed one and ``sweep``) and the two against each
    other, with the planted faults; the same bits twice; time both
    instances interleaved (CUDA graphs) beside the plain versions and the
    bounds, and the scan's checkpointing forward beside the serve forward.
    Returns a record per kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import rwkv6 as wk
    from repro_torch.kernels import selective_scan as ss

    t_phase = time.perf_counter()
    print("recurrent backward kernel checks against torch.autograd.grad of the "
          "plain forwards (grad_agreement: fp32 1e-5 relative Frobenius per "
          "gradient, bf16 2^-7; per element 1e-4 / 2^-6 of |ref| + row rms + "
          "0.1 x the gradient's rms):", flush=True)
    rec = {}
    for (what, b, t, h, dt_name, w_mean, states, timed) in RWKV_BWD_CASES:
        dtype = getattr(torch, dt_name)
        shape = (b, t, h, RWKV_HEAD)
        r, k, v, w = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(4))
        ops = tuple(x.to(dtype) for x in (r, k, v, w + w_mean)) + (
            torch.randn((h, RWKV_HEAD), generator=gen, device=dev),)
        s0, ds = ((torch.randn((b, h, RWKV_HEAD, RWKV_HEAD), generator=gen,
                               device=dev) for _ in range(2))
                  if states else (None, None))
        dout = torch.randn(shape, generator=gen, device=dev)
        routed = wk.choose_bwd_instance(*ops[:4])
        require(routed == ("chunked" if dtype == torch.bfloat16 else "sweep"),
                f"rwkv6_bwd {what}: the chooser took {routed} for {dt_name}")
        reset_launch_counts()
        plain0 = wk.rwkv6_bwd_plain.calls
        got = wk.rwkv6_bwd(*ops, dout, state0=s0, dstate=ds)
        torch.cuda.synchronize()
        require(launch_counts()["rwkv6_bwd"] == 1
                and instance_counts()["rwkv6_bwd"][routed] == 1
                and wk.rwkv6_bwd_plain.calls == plain0,
                f"rwkv6_bwd {what}: launches {launch_counts()}, instances "
                f"{instance_counts()['rwkv6_bwd']}")
        want = wkv_grad_ref(torch, ops, s0, dout, ds)
        require(all(bool(torch.isfinite(x).all()) for x in got if x is not None),
                f"rwkv6_bwd {what}: a non-finite gradient")
        agree = wk.grad_agreement(got, want)
        require(agree["ok"], f"rwkv6_bwd {what}: kernel [{routed}] != autograd "
                f"of plain ({bwd_readings(agree)})")
        again = wk.rwkv6_bwd(*ops, dout, state0=s0, dstate=ds)
        require(all(x is None or torch.equal(x, y)
                    for x, y in zip(got, again, strict=True)),
                f"rwkv6_bwd {what}: a second launch gave other bits")
        print(f"  rwkv6_bwd {what} [{b},{t},{h},64] {dt_name}, w ~ N({w_mean:g},"
              f" 1){', state0 and dstate' if states else ''}: [{routed}] "
              f"{bwd_readings(agree)}; the same bits twice", flush=True)
        if routed == "chunked":
            sweep = wk._bwd_launch(*ops, dout, state0=s0, dstate=ds,
                                   instance="sweep")
            a_s = wk.grad_agreement(sweep, want)
            a_x = wk.grad_agreement(got, sweep)
            require(a_s["ok"] and a_x["ok"], f"rwkv6_bwd {what}: sweep against "
                    f"autograd ({bwd_readings(a_s)}), chunked against sweep "
                    f"({bwd_readings(a_x)})")
            print(f"    [sweep] {bwd_readings(a_s)}; chunked against sweep: "
                  f"{bwd_readings(a_x)}", flush=True)
        else:
            # chunked on fp32 operands, never routed there: its TF32
            # products against fp32's limits, the reading that keeps fp32
            # on sweep
            tf32 = wk.grad_agreement(wk._bwd_launch(
                *ops, dout, state0=s0, dstate=ds, instance="chunked"), want)
            frob = {n: tf32[n]["rel_frob"] for n in wk.GRAD_NAMES if n in tf32}
            require(all(f <= 2.0 ** -7 for f in frob.values()),
                    f"rwkv6_bwd {what}: chunked on fp32 operands past bf16's "
                    f"limit ({bwd_readings(tf32)})")
            rec["rwkv6_bwd_fp32_chunked"] = {"case": what, "ok": tf32["ok"],
                                             "rel_frob": frob}
            print(f"    [chunked] on fp32 operands (TF32 products; dstate0's "
                  f"chunk products 3xTF32): {bwd_readings(tf32)}; within "
                  f"fp32's limits: {tf32['ok']}", flush=True)
        if timed:
            faults = list(wkv_bwd_faults(ops, dout, got))
            faults += list(wkv_chunked_faults(ops, dout))
            for fault, bad in faults:
                a = wk.grad_agreement(bad, want)
                require(not a["ok"], f"rwkv6_bwd: the check accepts a planted "
                        f"fault ({fault}: {bwd_readings(a)})")
                print(f"    control, {fault}: rejected (worst rel. Frobenius "
                      f"{max(a[n]['rel_frob'] for n in wk.GRAD_NAMES if n in a):.3e})",
                      flush=True)
            plain = wk.rwkv6_bwd_chunked_plain(*ops, dout)
            a_p = wk.grad_agreement(got, plain)
            require(a_p["ok"], f"rwkv6_bwd {what}: kernel != its plain version "
                    f"({bwd_readings(a_p)})")
            # the function's bound at the routed instance's rate: TF32
            # products for chunked (bf16 operands), fp32 for sweep
            nbytes, flops = wkv_bwd_work(b, t, h, ops[0].element_size())
            bms, by = bound(nbytes, flops, TF32_OPS_PER_S if routed == "chunked"
                            else FP32_OPS_PER_S)
            cbytes, cflops = wkv_chunked_work(b, t, h, ops[0].element_size())
            cbms, cby = bound(cbytes, cflops, TF32_OPS_PER_S)
            timed_ms = interleaved_ms(torch, {
                inst: (lambda inst=inst: wk._bwd_launch(*ops, dout,
                                                        instance=inst))
                for inst in wk.BWD_INSTANCES},
                ("sweep", "chunked", "chunked", "sweep"), 10)
            rec["rwkv6_bwd"] = r_ = {
                "shape": f"{dt_name} r, k, v, w [{b},{t},{h},64], fp32 dout",
                "instance": routed,
                "max_abs_err": max(agree[n]["max_abs_err"] for n in
                                   wk.GRAD_NAMES if n in agree),
                "rel_frob": {n: agree[n]["rel_frob"] for n in wk.GRAD_NAMES
                             if n in agree},
                "ms": timed_ms["chunked"], "sweep_ms": timed_ms["sweep"],
                "plain_ms": time_ms(torch, lambda: wk.rwkv6_bwd_chunked_plain(
                    *ops, dout), 1),
                "autograd_plain_ms": time_ms(torch, lambda: wkv_grad_ref(
                    torch, ops, None, dout, None), 1),
                "forward_ms": time_ms(torch, lambda: wk.rwkv6(*ops), 10),
                "bound_ms": bms, "bound_by": by,
                "fp32_ops_ms": flops / FP32_OPS_PER_S * 1e3}
            print(f"    kernel [chunked] {r_['ms']:.4f} ms, sweep {r_['sweep_ms']:.4f}"
                  f" ms (CUDA graphs, interleaved sweep, chunked, chunked, "
                  f"sweep; the forward at this shape {r_['forward_ms']:.4f} ms), "
                  f"plain {r_['plain_ms']:.2f} ms, autograd of the plain forward "
                  f"{r_['autograd_plain_ms']:.2f} ms; the function's bound "
                  f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB; {flops / 1e9:.2f} "
                  f"GFLOP take {flops / TF32_OPS_PER_S * 1e3:.4f} ms at TF32's "
                  f"rate, {r_['fp32_ops_ms']:.4f} ms at fp32's, the sweep's "
                  f"yardstick): {100 * bms / r_['ms']:.1f} % of it; with the "
                  f"chunked design's fp32 scratch and its {cflops / 1e9:.2f} "
                  f"GFLOP of TF32 products, {cbms:.4f} ms ({cby}: "
                  f"{cbytes / 1e6:.1f} MB); the kernel against its plain "
                  f"version: {bwd_readings(a_p)}", flush=True)
        del ops, s0, ds, dout, got, want, again, r, k, v, w
        torch.cuda.empty_cache()

    for (what, b, t, dt_name, dt_mean, with_ds, timed) in SCAN_BWD_CASES:
        dtype = getattr(torch, dt_name)
        xz = torch.randn((b, t, 2 * SCAN_DI), generator=gen, device=dev).to(dtype)
        bc = torch.randn((b, t, 2 * SCAN_N), generator=gen, device=dev).to(dtype)
        dtv = F.softplus(torch.randn((b, t, SCAN_DI), generator=gen, device=dev)
                         + dt_mean).to(dtype)
        a = -torch.arange(1, SCAN_N + 1, dtype=torch.float32, device=dev).expand(
            SCAN_DI, SCAN_N) * (1 + 0.1 * torch.rand((SCAN_DI, 1), generator=gen,
                                                      device=dev))
        ops = (xz[..., :SCAN_DI], dtv, a.contiguous(), bc[..., :SCAN_N],
               bc[..., SCAN_N:])
        dy = torch.randn((b, t, SCAN_DI), generator=gen, device=dev)
        ds = (torch.randn((b, SCAN_DI, SCAN_N), generator=gen, device=dev)
              if with_ds else None)
        routed = ss.choose_bwd_instance(ops[0], ops[1], ops[3], ops[4])
        other = "sweep" if routed == "tma" else "tma"
        require(routed == ("tma" if dtype == torch.bfloat16 else "sweep"),
                f"selective_scan_bwd {what}: the chooser took {routed} for the "
                f"model's {dt_name} views")
        reset_launch_counts()
        plain0 = ss.selective_scan_bwd_plain.calls
        _, _, hck = ss._forward(*ops, return_state=True, checkpoints=True)
        got = ss.selective_scan_bwd(*ops, dy, dstate=ds, checkpoints=hck)
        torch.cuda.synchronize()
        require(launch_counts()["selective_scan_bwd"] == 1
                and instance_counts()["selective_scan_bwd"][routed] == 1
                and instance_counts()["selective_scan"]["tma"] == 1
                and ss.selective_scan_bwd_plain.calls == plain0,
                f"selective_scan_bwd {what}: launches {launch_counts()}, "
                f"instances {instance_counts()['selective_scan']}, "
                f"{instance_counts()['selective_scan_bwd']}")
        want = scan_grad_ref(torch, ops, dy, ds)
        require(all(bool(torch.isfinite(x).all()) for x in got),
                f"selective_scan_bwd {what}: a non-finite gradient")
        agree = ss.grad_agreement(got, want)
        require(agree["ok"], f"selective_scan_bwd {what}: kernel [{routed}] != "
                f"autograd of plain ({bwd_readings(agree)})")
        again = ss.selective_scan_bwd(*ops, dy, dstate=ds, checkpoints=hck)
        require(all(torch.equal(x, y) for x, y in zip(got, again, strict=True)),
                f"selective_scan_bwd {what}: a second launch gave other bits")
        sweep = ss._bwd_launch(*ops, dy, dstate=ds, checkpoints=hck,
                               instance=other)
        a_s = ss.grad_agreement(sweep, want)
        a_x = ss.grad_agreement(got, sweep)
        require(a_s["ok"] and a_x["ok"], f"selective_scan_bwd {what}: {other} "
                f"against autograd ({bwd_readings(a_s)}), {routed} against "
                f"{other} ({bwd_readings(a_x)})")
        # the simple instance's checkpoints feed the same backward
        _, _, hck_s = ss._launch(*ops, instance="simple", return_state=True,
                                 checkpoints=True)
        agree_s = ss.grad_agreement(ss.selective_scan_bwd(
            *ops, dy, dstate=ds, checkpoints=hck_s), want)
        require(agree_s["ok"], f"selective_scan_bwd {what} from the simple "
                f"instance's checkpoints: {bwd_readings(agree_s)}")
        print(f"  selective_scan_bwd {what} [{b},{t},{SCAN_DI},{SCAN_N}] "
              f"{dt_name}{', dstate' if with_ds else ''}: [{routed}] "
              f"{bwd_readings(agree)}; the same bits twice; [{other}] "
              f"{bwd_readings(a_s)}; {routed} against {other}: "
              f"{bwd_readings(a_x)}; "
              f"from the simple instance's checkpoints within the limits too",
              flush=True)
        if dtype == torch.float32:      # the chooser's fp32 rule, on the card
            fp32_ms = interleaved_ms(torch, {
                inst: (lambda inst=inst: ss._bwd_launch(
                    *ops, dy, dstate=ds, checkpoints=hck, instance=inst))
                for inst in ss.BWD_INSTANCES}, ("sweep", "tma", "tma", "sweep"),
                5)
            rec["selective_scan_bwd_fp32"] = fp32_ms
            print(f"    fp32 operands: [sweep] {fp32_ms['sweep']:.4f} ms, tma "
                  f"{fp32_ms['tma']:.4f} ms (CUDA graphs, interleaved)",
                  flush=True)
        if timed:
            for fault, bad in scan_bwd_faults(ops, dy, hck, got):
                f = ss.grad_agreement(bad, want)
                require(not f["ok"], f"selective_scan_bwd: the check accepts a "
                        f"planted fault ({fault}: "
                        f"{bwd_readings(f)})")
                print(f"    control, {fault}: rejected (worst rel. Frobenius "
                      f"{max(f[n]['rel_frob'] for n in ss.GRAD_NAMES):.3e})",
                      flush=True)
            nbytes, ops_n = scan_bwd_work(b, t, SCAN_DI, SCAN_N,
                                          ops[0].element_size())
            bms, by = bound(nbytes, ops_n, FP32_OPS_PER_S)
            exps = b * t * SCAN_DI * SCAN_N
            mufu_ms = exps / (MUFU_PER_SM_CLOCK * sms * SM_CLOCK_HZ) * 1e3
            timed_ms = interleaved_ms(torch, {
                inst: (lambda inst=inst: ss._bwd_launch(
                    *ops, dy, checkpoints=hck, instance=inst))
                for inst in ss.BWD_INSTANCES}, ("sweep", "tma", "tma", "sweep"),
                10)
            rec["selective_scan_bwd"] = r_ = {
                "shape": f"{dt_name} u, dt [{b},{t},{SCAN_DI}] (u a view of "
                         f"[{b},{t},{2 * SCAN_DI}]), b, c [{b},{t},{SCAN_N}] "
                         f"(views), fp32 dy and checkpoints",
                "instance": routed,
                "max_abs_err": max(agree[n]["max_abs_err"]
                                   for n in ss.GRAD_NAMES),
                "rel_frob": {n: agree[n]["rel_frob"] for n in ss.GRAD_NAMES},
                "ms": timed_ms["tma"], "sweep_ms": timed_ms["sweep"],
                "plain_ms": time_ms(torch, lambda: ss.selective_scan_bwd_plain(
                    *ops, dy), 1),
                "autograd_plain_ms": time_ms(torch, lambda: scan_grad_ref(
                    torch, ops, dy, None), 1),
                "forward_ckpt_ms": time_ms(torch, lambda: ss._forward(
                    *ops, return_state=True, checkpoints=True), 20),
                "forward_serve_ms": time_ms(torch, lambda: ss.selective_scan(
                    *ops, return_state=True), 20),
                "bound_ms": bms, "bound_by": by, "mufu_ms": mufu_ms,
                "fp32_ops_ms": ops_n / FP32_OPS_PER_S * 1e3}
            print(f"    kernel [tma] {r_['ms']:.4f} ms, sweep {r_['sweep_ms']:.4f} "
                  f"ms (CUDA graphs, interleaved sweep, tma, tma, sweep), plain "
                  f"{r_['plain_ms']:.2f} ms, autograd of the plain forward "
                  f"{r_['autograd_plain_ms']:.2f} ms, bound {bms:.4f} ms ({by}: "
                  f"{nbytes / 1e6:.1f} MB; {ops_n / 1e9:.2f} G fp32 operations "
                  f"take {r_['fp32_ops_ms']:.4f} ms): {100 * bms / r_['ms']:.1f} "
                  f"% of the bound; one exponential an element takes "
                  f"{mufu_ms:.4f} ms on the special-function units (tma takes "
                  f"1.5, sweep 2); the forward [tma] with checkpoints "
                  f"{r_['forward_ckpt_ms']:.4f} ms, without (serve) "
                  f"{r_['forward_serve_ms']:.4f} ms", flush=True)
        del ops, xz, bc, dtv, a, dy, ds, hck, got, want, again, hck_s, sweep
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"recurrent backward phase: {rec['phase_s']:.1f} s", flush=True)
    return rec


# the multi-rank phase: (a) llama3.2-1b at full width and depth, 3 steps on
# one rank of NCCL against the one-card train_loop; (b) two ranks on the
# one card over gloo, llama3.2-1b at full width cut to 2 layers, 3 steps:
# FSDP (data = 2) against one rank with 2 microbatches, then pod = 2 with
# compress_pod; both on the repeated [4, 2048] batch of the train phase
RANK_STEPS, RANK_LAYERS = 3, 2
# losses and weights of two trainers that must agree (relative, Frobenius)
RANK_TOL = 1e-6


def _rank_tc():
    from repro_torch.train.step import TrainConfig

    return TrainConfig(peak_lr=3e-4, warmup=0, stable=10_000, decay=1_000,
                       seq_chunk=512)


def multirank_phase(torch, np, dev, seed, card):
    """The multi-rank trainer on the card (phase 16): (a) one NCCL rank
    against the one-card trainer at full width and depth, (b) two ranks
    on the one card over gloo, FSDP against one rank with microbatches and
    ``compress_pod``'s guarantees read from the trainer's own reductions
    at every step (``tools/multicard_train.py``), (c) the dry-run report
    on the card's machine (no JAX there).  Returns the ``{"multirank":
    ...}`` record."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.launch.train import init_ranks, train_loop
    from repro_torch.parallel import fsdp

    t_phase = time.perf_counter()
    cfg = get_config("llama3.2-1b")
    tc = _rank_tc()
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=seed)
    data = mc.Repeated(tokens)
    kw = dict(steps=RANK_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              ckpt_dir=None, log_every=100, seed=seed, device=dev, data=data)
    print(f"multirank: (a) {cfg.name} at full width and depth, {RANK_STEPS} "
          f"steps of the repeated [{TRAIN_BATCH},{TRAIN_SEQ}] batch: the "
          f"one-card train_loop, then one rank of NCCL (launch.train's "
          f"--nproc 1 path) on the same seed and batch", flush=True)
    p1, o1, l1 = train_loop(cfg, tc, **kw)
    torch.cuda.synchronize()
    rec = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        init_ranks(0, 1, device="cuda", backend=None, init_method=init)
        try:
            backend = dist.get_backend()
            mesh = process_mesh((1,), ("data",), device="cuda")
            fsdp.reset_stats()
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            history = []
            p2, o2, l2 = train_loop(cfg, tc, mesh=mesh, history=history, **kw)
            torch.cuda.synchronize()
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            calls = dict(fsdp.STATS["calls"])
        finally:
            dist.destroy_process_group()
    require(backend == "nccl", f"(a) the rank ran on {backend}, not nccl")
    n_leaves = sum(1 for _ in p1.parameters())
    require(calls == {"all_gather": RANK_STEPS * (n_leaves + 1)},
            f"(a) collectives {calls}: want one NCCL all_gather a gradient "
            f"and one for the loss, each step ({n_leaves} leaves)")
    require(counts["flash_attention_bwd"] == cfg.n_layers * RANK_STEPS,
            f"(a) launch counts {counts}")
    cmp = mc.compare(
        {"losses": l2, "weights": {n: p.detach()
                                   for n, p in p2.named_parameters()}},
        {"losses": l1, "weights": {n: p.detach()
                                   for n, p in p1.named_parameters()}})
    step_ms = mc.steady_ms(history)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"  (a) losses one-card {l1}, NCCL rank {l2}: largest relative "
          f"difference {cmp['loss_diff']:.3e}; weights: "
          f"{cmp['bit_equal_leaves']} of {n_leaves} leaves bit-equal, "
          f"largest relative Frobenius difference {cmp['weight_diff']:.3e} "
          f"(the check: {RANK_TOL}); {step_ms:.1f} ms per step over steps "
          f"1..{RANK_STEPS - 1} ({tok_s:.0f} tokens/s), peak memory "
          f"{peak / 2**30:.2f} GiB (both trainers' states resident); "
          f"collectives {calls} on {backend} ({card})", flush=True)
    require(cmp["loss_diff"] <= RANK_TOL and cmp["weight_diff"] <= RANK_TOL,
            f"(a) the NCCL rank differs from the one-card trainer: {cmp}")
    rec["a"] = {"losses": l2, "one_card_losses": l1,
                "loss_diff": cmp["loss_diff"],
                "weight_diff": cmp["weight_diff"],
                "bit_equal_leaves": cmp["bit_equal_leaves"],
                "leaves": n_leaves, "step_ms": step_ms, "tokens_per_s": tok_s,
                "peak_gib": peak / 2**30, "collectives": calls,
                "backend": backend}
    del p1, o1, p2, o2
    torch.cuda.empty_cache()

    # ---- (b) two ranks on the one card over gloo
    cut = dataclasses.replace(cfg, n_layers=RANK_LAYERS)
    print(f"multirank: (b) {cut.name} at full width cut to {RANK_LAYERS} "
          f"layers, [{TRAIN_BATCH},{TRAIN_SEQ}] split 2 + 2 over two ranks "
          f"on the one card (gloo): FSDP (data = 2) against one rank with 2 "
          f"microbatches, then pod = 2 with compress_pod", flush=True)
    job = dict(cfg=cut, tc=tc, device="cuda", backend="gloo",
               steps=RANK_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed)
    ref = mc.one_rank(cut, dataclasses.replace(tc, microbatches=2),
                      device=dev, steps=RANK_STEPS, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, seed=seed)
    torch.cuda.empty_cache()
    f = mc.spawn(**job, shape=(2,), axes=("data",))
    require(f["backend"] == "gloo" and len(f["split"]) > 0,
            f"(b) FSDP on {f['backend']}, split leaves {f['split']}")
    cmp = mc.compare(f, ref)
    f_ms = mc.steady_ms(f["history"])
    print(f"  (b) FSDP: {len(f['split'])} leaves split over data; losses "
          f"{f['losses']} against one rank's {ref['losses']}: largest "
          f"relative difference {cmp['loss_diff']:.3e}; weights: "
          f"{cmp['bit_equal_leaves']} of {cmp['leaves']} leaves bit-equal, "
          f"largest relative Frobenius difference {cmp['weight_diff']:.3e} "
          f"(the check: {RANK_TOL}); rank 0: {f_ms:.1f} ms per step over "
          f"steps 1..{RANK_STEPS - 1}; collectives {f['calls']}; peak memory "
          f"{f['peak'] / 2**30:.2f} GiB a rank; the one-rank reference "
          f"{1e3 * ref['s'] / RANK_STEPS:.1f} ms a step (step 0's set-up "
          f"included); {f['wall_s']:.1f} s wall with the spawn ({card})",
          flush=True)
    require(cmp["loss_diff"] <= RANK_TOL and cmp["weight_diff"] <= RANK_TOL,
            f"(b) FSDP differs from one rank with microbatches: {cmp}")
    c = mc.spawn(**job, shape=(2,), axes=("pod",), compress=True)
    rep = c["report"]
    print(f"  (b) compress_pod, the trainer's own reductions at each of "
          f"{rep['steps']} steps: residuals fed back from the state "
          f"{rep['fed_back']}, scale {rep['scale']}, q {rep['q_exact']}, "
          f"residuals equal g32 - q*scale {rep['residual_exact']}, the state "
          f"holds the last {rep['state_holds_residuals']}; worst |out - "
          f"mean| / (scale/2) {rep['worst_over_half_scale']:.4f}; losses "
          f"{c['losses']}; {c['calls']} ({c['wall_s']:.1f} s wall with the "
          f"spawn)", flush=True)
    require(rep["ok"], f"(b) compressed_psum's guarantees fail: {rep}")
    require(c["losses"][-1] < c["losses"][0],
            f"(b) compress_pod: the loss did not fall {c['losses']}")
    rec["b"] = {"fsdp": {"losses": f["losses"],
                         "reference_losses": ref["losses"],
                         "loss_diff": cmp["loss_diff"],
                         "weight_diff": cmp["weight_diff"],
                         "bit_equal_leaves": cmp["bit_equal_leaves"],
                         "split_leaves": len(f["split"]), "step_ms": f_ms,
                         "calls": f["calls"],
                         "peak_gib": f["peak"] / 2**30},
                "compress": {"losses": c["losses"], "report": rep,
                             "calls": c["calls"]}}

    # ---- (c) the dry-run on this machine (no JAX here)
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun")
    cell = dryrun.run_cell("llama3.2-1b", "train_4k", multi_pod=False,
                           out_dir=out_dir)
    mpc = dryrun.run_mpc_cell(multi_pod=False, out_dir=out_dir)
    mem = cell["memory"]
    print(f"  (c) dry-run llama3.2-1b x train_4k on the (16, 16) mesh: per "
          f"device {mem['argument_size_in_bytes'] / 1e9:.3f} GB arguments + "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB temporaries of 80 GB; "
          f"roofline {cell['roofline']}; MPC step: {mpc['roofline']}",
          flush=True)
    rec["c"] = {"cell": {"memory": mem, "roofline": cell["roofline"],
                         "flops": cell["hlo_analysis"]["flops"],
                         "collective_bytes": cell["collectives"]["total_bytes"]},
                "mpc": {"roofline": mpc["roofline"],
                        "flops": mpc["hlo_analysis"]["flops"],
                        "kernel_calls": mpc["hlo_analysis"]["kernel_calls"]}}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"multirank phase: {rec['phase_s']:.1f} s", flush=True)
    return rec


def train_phase(torch, np, dev, seed):
    """Train llama3.2-1b at full width and depth on a repeated batch; an
    exact-step resume at a two-layer cut; the fp32 two-layer cut against
    plain attention under autograd; whisper-small at full width;
    rwkv6-1.6b at full width and depth and jamba at full width cut to 2
    layers, each with its reduced fp32 step against the CPU's.  Returns the
    records of the report."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train_loop
    from repro_torch.models import jamba as jb
    from repro_torch.models import transformer as tr
    from repro_torch.models import whisper as wh
    from repro_torch.train.step import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = get_config("llama3.2-1b")
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings,
             cfg.dtype, cfg.remat)
            == (N_LAYERS, D_MODEL, N_HEADS, N_KV, HEAD_DIM, 8192, VOCAB, True,
                "bfloat16", True), f"llama3.2-1b config changed: {cfg}")
    tc = TrainConfig(peak_lr=3e-4, warmup=0, stable=10_000, decay=1_000,
                     seq_chunk=512)
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=seed)
    print(f"train: {cfg.name} at its published config ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
          f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab} tied, "
          f"{cfg.dtype}, remat per layer); AdamW in fp32 ({tc}); one batch of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens from seed {seed}, repeated for "
          f"{TRAIN_STEPS} steps", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain0 = fa.flash_attention_plain.calls
    history = []
    reset_launch_counts()
    params, opt_state, losses = train_loop(
        cfg, tc, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        ckpt_dir=None, log_every=1, seed=seed, device=dev,
        data=mc.Repeated(tokens), history=history)
    torch.cuda.synchronize()
    counts = launch_counts()
    inst = instance_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    require({k: counts[k] for k in want} == want
            and sum(counts.values()) == sum(want.values()),
            f"llama train: launch counts {counts}, want {want} (16 forward "
            f"launches, 16 more in remat's recompute and 16 backward a step)")
    require(inst["flash_attention"]["wgmma"] == want["flash_attention"]
            and inst["flash_attention_bwd"]["wgmma"]
            == want["flash_attention_bwd"],
            f"llama train: instances {inst}")
    require(fa.flash_attention.lse_launches == want["flash_attention"],
            f"llama train: {fa.flash_attention.lse_launches} forward launches "
            f"wrote lse")
    require(fa.flash_attention_plain.calls == plain0,
            "llama train: plain attention ran on the card")
    require(all(np.isfinite([h["loss"], h["gnorm"]]).all() for h in history),
            "llama train: a non-finite loss or gradient norm")
    drop = losses[0] - losses[-1]
    require(drop >= TRAIN_DROP, f"llama train: the loss fell by {drop:.3f}, "
            f"less than {TRAIN_DROP} ({losses})")
    steady = [h["s"] for h in history[1:]]
    step_ms = 1e3 * sum(steady) / len(steady)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    for h in history:
        print(f"  step {h['step']}: loss {h['loss']:.4f}, lr {h['lr']:.2e}, "
              f"gnorm {h['gnorm']:.4f}, {1e3 * h['s']:.1f} ms", flush=True)
    print(f"  {n_params / 1e9:.3f} B parameters; {step_ms:.1f} ms per step over "
          f"steps 1..{TRAIN_STEPS - 1} ({tok_s:.0f} tokens/s; step 0 "
          f"{1e3 * history[0]['s']:.1f} ms); peak memory {peak / 2**30:.2f} GiB; "
          f"the loss fell by {drop:.3f} (the check: at least {TRAIN_DROP}); per "
          f"step {want['flash_attention'] // TRAIN_STEPS} flash forward "
          f"launches (wgmma, lse written) and "
          f"{want['flash_attention_bwd'] // TRAIN_STEPS} backward (wgmma), "
          f"no plain attention", flush=True)
    llama = {"step_ms": step_ms, "tokens_per_s": tok_s, "peak_gib": peak / 2**30,
             "losses": losses, "history": history, "n_params": n_params,
             "launches": counts["flash_attention_bwd"],
             "forward_launches": counts["flash_attention"]}
    # where one more step's device time goes (the counters were read above)
    step_fn = make_train_step(cfg, tc)
    batch = tokens.batch(0, device=dev)
    device_share(torch, f"llama3.2-1b train step [{TRAIN_BATCH},{TRAIN_SEQ}]",
                 lambda: step_fn(params, opt_state, batch), "flash", top=12)
    del params, opt_state, batch
    torch.cuda.empty_cache()

    # ---- exact-step resume through CheckpointManager, two layers, full width
    cut = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    whole_p, _, whole = train_loop(cut, tc, steps=RESUME_STEPS,
                                   global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                   ckpt_dir=None, log_every=100, seed=seed,
                                   device=dev)
    half = RESUME_STEPS // 2
    first_p, first_opt, first = train_loop(
        cut, tc, steps=half, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        ckpt_dir=ckpt, ckpt_every=half, log_every=100, seed=seed, device=dev)
    mgr = CheckpointManager(ckpt)
    require(mgr.all_steps() == [half], f"resume: checkpoints {mgr.all_steps()}")
    like_p, like_opt = init_train_state(cut, tc, seed + 1, device=dev)
    back = mgr.restore(half, {"params": like_p, "opt": like_opt})
    exact = (all(torch.equal(p, q) for p, q in zip(
        back["params"].parameters(), first_p.parameters(), strict=True))
        and int(back["opt"].step) == int(first_opt.step) == half
        and all(torch.equal(back["opt"].mu[k], first_opt.mu[k])
                and torch.equal(back["opt"].nu[k], first_opt.nu[k])
                for k in first_opt.mu))
    require(exact, "resume: the restored state differs from the saved one")
    del like_p, like_opt, back, first_p, first_opt
    resumed_p, _, rest = train_loop(
        cut, tc, steps=RESUME_STEPS, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, ckpt_dir=ckpt, log_every=100, seed=seed, device=dev)
    both = first + rest
    rel = max(abs(a - b) / abs(b) for a, b in zip(both, whole, strict=True))
    require(len(both) == len(whole) and rel <= RESUME_TOL,
            f"resume: losses {both} against the uninterrupted {whole}")
    with torch.no_grad():
        wdiff = max(float((p.float() - q.float()).abs().max()) for p, q in zip(
            resumed_p.parameters(), whole_p.parameters(), strict=True))
    ck_bytes = sum(os.path.getsize(os.path.join(ckpt, f"step_{s:08d}",
                                                "arrays.npz"))
                   for s in mgr.all_steps())
    print(f"  resume ({RESUME_LAYERS} layers at full width): uninterrupted "
          f"losses {[round(x, 4) for x in whole]}, saved at step {half} and "
          f"resumed {[round(x, 4) for x in both]}: max relative difference "
          f"{rel:.2e} (limit {RESUME_TOL}); the restored state equal to the "
          f"saved one bit for bit; the final weights differ by at most "
          f"{wdiff:.3e}; {ck_bytes / 1e9:.2f} GB in {len(mgr.all_steps())} "
          f"checkpoints; {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    resume = {"losses": whole, "resumed": both, "max_rel": rel,
              "weights_max_abs": wdiff}
    del whole_p, resumed_p
    torch.cuda.empty_cache()

    # ---- fp32 two-layer cut: the kernels against plain attention, autograd
    cut32 = dataclasses.replace(cut, dtype="float32")
    p32 = tr.init_params(cut32, seed, device=dev).requires_grad_(True)
    named = dict(p32.named_parameters())
    host = SyntheticTokens(vocab=cfg.vocab, seq_len=1024, global_batch=2,
                           seed=seed).batch(0, device=dev)

    def loss_and_grads():
        loss = tr.loss_fn(cut32, p32, host["tokens"], host["targets"])
        grads = torch.autograd.grad(loss, list(named.values()))
        return float(loss.detach()), grads

    reset_launch_counts()
    got_loss, got = loss_and_grads()
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts["flash_attention"] == 2 * RESUME_LAYERS
            and counts["flash_attention_bwd"] == RESUME_LAYERS
            and instance_counts()["flash_attention_bwd"]["cuda_core"]
            == RESUME_LAYERS, f"fp32 cut: launches {counts}")
    kernel_attn = tr.attention_chunked
    tr.attention_chunked = lambda q, k, v, causal: fa.flash_attention_plain(
        q, k, v, causal=causal)
    try:
        want_loss, want = loss_and_grads()
    finally:
        tr.attention_chunked = kernel_attn
    errs = {n: float((g - w).norm() / w.norm().clamp_min(1e-30))
            for n, g, w in zip(named, got, want, strict=True)}
    worst = max(errs, key=errs.get)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    require(loss_rel <= CUT_TOL and errs[worst] <= CUT_TOL,
            f"fp32 cut: loss {got_loss} against {want_loss}, gradient {worst} "
            f"off by {errs[worst]:.3e}")
    print(f"  fp32 cut ({RESUME_LAYERS} layers, full width, [2,1024]): loss "
          f"{got_loss:.6f} with the kernels, {want_loss:.6f} with plain "
          f"attention under autograd (relative {loss_rel:.2e}); worst gradient "
          f"{worst} at {errs[worst]:.2e} relative Frobenius (limit {CUT_TOL}); "
          f"{counts['flash_attention']} forward and "
          f"{counts['flash_attention_bwd']} backward launches (cuda_core)",
          flush=True)
    cut_rec = {"loss_rel": loss_rel, "worst_grad": worst,
               "worst_rel_frob": errs[worst]}
    del p32, named, got, want
    torch.cuda.empty_cache()

    # ---- whisper-small at full width and depth
    wcfg = get_config("whisper-small")
    b, t, frames, steps = WHISPER_TRAIN
    wtc = TrainConfig(peak_lr=3e-4, warmup=0, seq_chunk=512)
    wparams, wstate = init_train_state(wcfg, wtc, seed, device=dev)
    step_fn = make_train_step(wcfg, wtc)
    batch = SyntheticTokens(vocab=wcfg.vocab, seq_len=t, global_batch=b,
                            seed=seed).batch(0, device=dev)
    batch["embeds"] = torch.randn((b, frames, wcfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev).to(getattr(torch, wcfg.dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, wlosses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        wparams, wstate, m = step_fn(wparams, wstate, batch)
        wlosses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        require(np.isfinite(wlosses[-1]) and np.isfinite(float(m["gnorm"])),
                "whisper train: a non-finite loss or gradient norm")
    counts = launch_counts()
    per_step = wcfg.n_enc_layers + 2 * wcfg.n_layers
    inst = instance_counts()
    require(counts["flash_attention"] == 2 * per_step * steps
            and counts["flash_attention_bwd"] == per_step * steps
            and sum(counts.values()) == 3 * per_step * steps,
            f"whisper train: launch counts {counts}")
    # bf16 frames (launch.train's cast): every attention is aligned bf16 at
    # D = 64, so both directions take wgmma
    require(inst["flash_attention"]["wgmma"] == counts["flash_attention"]
            and inst["flash_attention_bwd"]["wgmma"]
            == counts["flash_attention_bwd"],
            f"whisper train: instances {inst}")
    wpeak = torch.cuda.max_memory_allocated()
    print(f"  whisper-small ({wcfg.n_enc_layers} + {wcfg.n_layers} layers, d "
          f"{wcfg.d_model}, {wcfg.dtype}): batch {b} x {t} tokens on {frames} "
          f"frames, {steps} steps: {[round(x, 1) for x in times]} ms, losses "
          f"{[round(x, 4) for x in wlosses]}; per step {2 * per_step} flash "
          f"forward and {per_step} backward launches, all wgmma (encoder "
          f"non-causal, decoder causal, cross T != S); peak memory "
          f"{wpeak / 2**30:.2f} GiB",
          flush=True)
    whisper = {"step_ms": min(times[1:]), "losses": wlosses,
               "peak_gib": wpeak / 2**30}
    device_share(torch, f"whisper-small train step [{b},{t}] on {frames} frames",
                 lambda: step_fn(wparams, wstate, batch), "flash", top=12)
    del wparams, wstate, batch
    torch.cuda.empty_cache()

    # ---- the recurrent families: rwkv6-1.6b, and jamba cut in depth
    out_rec = {}
    rcfg = get_config("rwkv6-1.6b")
    require((rcfg.family, rcfg.n_layers, rcfg.d_model, rcfg.d_ff, rcfg.vocab,
             rcfg.dtype, rcfg.remat) == ("ssm", RWKV_LAYERS,
                                         RWKV_HEADS * RWKV_HEAD, 7168, 65536,
                                         "bfloat16", True),
            f"rwkv6-1.6b config changed: {rcfg}")
    out_rec["rwkv6-1.6b"] = train_recurrent(
        torch, np, dev, seed, rcfg, RWKV_TRAIN_STEPS, RWKV_TRAIN_DROP,
        {"rwkv6": 2 * rcfg.n_layers, "rwkv6_bwd": rcfg.n_layers}, "wkv",
        {"rwkv6_bwd": "chunked"})
    full = get_config("jamba-v0.1-52b")
    jcfg = dataclasses.replace(full, n_layers=JAMBA_TRAIN_LAYERS)
    require(not any(jb.is_attn_layer(jcfg, l) for l in range(jcfg.n_layers))
            and [jb.is_moe_layer(jcfg, l) for l in range(jcfg.n_layers)]
            == [False, True] and jcfg.remat,
            f"jamba's first {JAMBA_TRAIN_LAYERS} layers: want Mamba + dense MLP, "
            f"Mamba + MoE")
    out_rec["jamba-v0.1-52b"] = train_recurrent(
        torch, np, dev, seed, jcfg, JAMBA_TRAIN_STEPS, JAMBA_TRAIN_DROP,
        {"selective_scan": 2 * jcfg.n_layers,
         "selective_scan_bwd": jcfg.n_layers}, "scan",
        {"selective_scan": "tma", "selective_scan_bwd": "tma"})
    for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        out_rec[arch]["fp32_cut"] = recurrent_fp32_step(torch, np, dev, arch)
    out = {"llama": llama, "resume": resume, "cut": cut_rec, "whisper": whisper,
           "recurrent": out_rec, "phase_s": time.perf_counter() - t_phase}
    print(f"train phase: {out['phase_s']:.1f} s", flush=True)
    return out


def train_recurrent(torch, np, dev, seed, cfg, steps, drop, per_mb, kernel,
                    instances):
    """Train ``cfg`` at full width on one repeated TRAIN_BATCH x TRAIN_SEQ
    batch for ``steps`` steps through ``launch.train.train_loop``, in its
    ``ARCH_TRAIN_OVERRIDES`` microbatches: launches exactly ``per_mb`` a
    microbatch of every step (nothing else, no plain version), every launch
    of a wrapper in ``instances`` on the instance it names, a finite and
    falling loss (by ``drop``); one more step under the profiler.  Returns
    the record of the report."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import rwkv6 as wk
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import ARCH_TRAIN_OVERRIDES, make_train_step

    mb = ARCH_TRAIN_OVERRIDES[cfg.name].microbatches
    tc = dataclasses.replace(ARCH_TRAIN_OVERRIDES[cfg.name], peak_lr=3e-4,
                             warmup=0, stable=10_000, decay=1_000, seq_chunk=512)
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=seed)
    print(f"train: {cfg.name} at its published width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, remat "
          f"per layer); AdamW in fp32 ({tc}); one batch of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens from seed {seed} in {mb} microbatches, repeated "
          f"for {steps} steps", flush=True)
    plains = (wk.rwkv6_plain, wk.rwkv6_bwd_plain, ss.selective_scan_plain,
              ss.selective_scan_bwd_plain)
    plain0 = [f.calls for f in plains]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []
    reset_launch_counts()
    params, opt_state, losses = train_loop(
        cfg, tc, steps=steps, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        ckpt_dir=None, log_every=1, seed=seed, device=dev,
        data=mc.Repeated(tokens), history=history)
    torch.cuda.synchronize()
    counts = launch_counts()
    by_instance = {name: instance_counts()[name] for name in instances}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    want = {k: v * mb * steps for k, v in per_mb.items()}
    require({k: counts[k] for k in want} == want
            and sum(counts.values()) == sum(want.values()),
            f"{cfg.name} train: launch counts {counts}, want {want} (a "
            f"microbatch: {per_mb}, the forward twice under remat)")
    require([f.calls for f in plains] == plain0,
            f"{cfg.name} train: a plain recurrence ran on the card")
    require(all(by_instance[name][inst] == counts[name]
                for name, inst in instances.items()),
            f"{cfg.name} train: instances {by_instance}, want every launch on "
            f"{instances}")
    print(f"  instances over the {steps} steps: {by_instance}", flush=True)
    require(all(np.isfinite([h["loss"], h["gnorm"]]).all() for h in history),
            f"{cfg.name} train: a non-finite loss or gradient norm")
    fell = losses[0] - losses[-1]
    require(fell >= drop, f"{cfg.name} train: the loss fell by {fell:.3f}, less "
            f"than {drop} ({losses})")
    steady = [h["s"] for h in history[1:]]
    step_ms = 1e3 * sum(steady) / len(steady)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    for h in history:
        print(f"  step {h['step']}: loss {h['loss']:.4f}, lr {h['lr']:.2e}, "
              f"gnorm {h['gnorm']:.4f}, {1e3 * h['s']:.1f} ms", flush=True)
    print(f"  {n_params / 1e9:.3f} B parameters; {step_ms:.1f} ms per step over "
          f"steps 1..{steps - 1} ({tok_s:.0f} tokens/s; step 0 "
          f"{1e3 * history[0]['s']:.1f} ms); peak memory {peak / 2**30:.2f} GiB; "
          f"the loss fell by {fell:.3f} (the check: at least {drop}); per step "
          + ", ".join(f"{v * mb} {k}" for k, v in per_mb.items())
          + " launches, nothing else, no plain recurrence", flush=True)
    step_fn = make_train_step(cfg, tc)
    batch = tokens.batch(0, device=dev)
    device_share(torch, f"{cfg.name} train step [{TRAIN_BATCH},{TRAIN_SEQ}]",
                 lambda: step_fn(params, opt_state, batch), kernel, top=12)
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": tok_s, "peak_gib": peak / 2**30,
            "losses": losses, "n_params": n_params, "launches": counts,
            "instances": by_instance, "microbatches": mb}


def recurrent_fp32_step(torch, np, dev, arch):
    """The reduced ``arch`` in fp32 (remat on) on the card through the
    recurrence kernels against the CPU: every gradient of ``loss_fn`` per
    weight, and one train step (2 microbatches): loss, gnorm and the
    updated weights, all within ``STEP_TOL`` in relative Frobenius norm.
    The updated weights are held as one vector: Adam's first step moves an
    element by ``lr g / (|g| + eps)``, which the last bits of a gradient
    near 0 decide, and on jamba's zero-initialised ``conv_b`` the CPU's own
    fp32 step lies farther than 1e-5 from an fp64 step, so no weight of
    that kind can be held alone at 1e-5.  Returns the worst relative
    differences."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.train.step import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              remat=True)
    model = get_model(cfg)
    tc = TrainConfig(warmup=0, seq_chunk=64, microbatches=2)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 256)))
             for k in ("tokens", "targets")}
    runs = {}
    for where in ("cpu", dev):
        params = model.init_params(cfg, 0, device="cpu").to(where)
        params.requires_grad_(True)
        on = {k: v.to(where) for k, v in batch.items()}
        named = dict(params.named_parameters())
        loss = model.loss_fn(cfg, params, on["tokens"], on["targets"],
                             seq_chunk=tc.seq_chunk)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(w) if g is None else g).detach().cpu()
                 for (n, w), g in zip(named.items(), grads, strict=True)}
        opt_state = make_optimizer(tc).init(params)
        reset_launch_counts()
        params, _, m = make_train_step(cfg, tc)(params, opt_state, on)
        runs[str(where)] = ({k: float(v) for k, v in m.items()}, grads,
                            torch.cat([p.detach().cpu().reshape(-1)
                                       for p in params.parameters()]),
                            launch_counts())
    (mc, gc, wc, _), (mg, gg, wg, counts) = runs["cpu"], runs[str(dev)]
    fwd, bwd = (("rwkv6", "rwkv6_bwd") if cfg.family == "ssm"
                else ("selective_scan", "selective_scan_bwd"))
    require(counts[bwd] > 0 and counts[fwd] == 2 * counts[bwd],
            f"{arch} fp32 step: launches {counts}")
    rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss", "gnorm")}
    errs = {n: float((gg[n] - w).norm() / w.norm().clamp_min(1e-30))
            for n, w in gc.items()}
    worst = max(errs, key=errs.get)
    wrel = float((wg - wc).norm() / wc.norm())
    require(max(rel.values()) <= STEP_TOL and errs[worst] <= STEP_TOL
            and wrel <= STEP_TOL,
            f"{arch} fp32 step: loss/gnorm {rel}, gradient {worst} off by "
            f"{errs[worst]:.3e}, weights by {wrel:.3e} (limit {STEP_TOL})")
    print(f"  {arch} reduced fp32 ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"[4,256]), card against CPU: worst gradient {worst} at "
          f"{errs[worst]:.2e} relative Frobenius; one step in 2 microbatches: "
          f"loss {mg['loss']:.6f} / {mc['loss']:.6f} (relative "
          f"{rel['loss']:.2e}), gnorm relative {rel['gnorm']:.2e}, the updated "
          f"weights {wrel:.2e} (limit {STEP_TOL} each); {counts[fwd]} {fwd} and "
          f"{counts[bwd]} {bwd} launches in the step", flush=True)
    return {"loss_rel": rel["loss"], "gnorm_rel": rel["gnorm"],
            "worst_grad": worst, "worst_grad_rel_frob": errs[worst],
            "weights_rel_frob": wrel}


def planted_faults(q, k, v, ref, *, causal, q_offset):
    """Two wrong outputs for the check against the plain version to reject,
    made with the plain version: the softmax scale off by 1 %, and the last
    64 query rows without the last 64 keys (a kv loop that stops one of the
    kernel's 64-key tiles early for the last q tile)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain

    t, s, d = q.shape[1], k.shape[1], q.shape[3]
    tile = 64
    yield "softmax scale x 1.01", flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_offset, scale=1.01 * d ** -0.5)
    tail = flash_attention_plain(q[:, t - tile:], k[:, :s - tile],
                                 v[:, :s - tile], causal=causal,
                                 q_offset=q_offset + t - tile)
    yield (f"last {tile} rows miss the last {tile} keys",
           torch.cat([ref[:, :t - tile], tail], dim=1))


def readings(a):
    """One line of an ``agreement`` record."""
    return (f"max |err| {a['max_abs_err']:.3e}, worst element "
            f"{a['worst']:.3f} of its limit, rel. Frobenius "
            f"{a['rel_frob']:.3e}")


def time_ms(torch, fn, iters):
    """Mean device time of one call over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, iters):
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed once between CUDA events, so the host's launch path (the
    wrapper, ``ctypes``, PyTorch's dispatch) is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ptxas_lines(log):
    """``-Xptxas -v`` usage lines, each under its kernel's short name."""
    out, name = [], "?"
    for line in log.splitlines():
        entry = re.search(
            r"\d((?:[a-z]+\d*_)*kernel)I?((?:Li\d+E|Lb\dE|f|13__nv_bfloat16)*)",
            line)
        if entry and "Compiling entry" in line:
            args = [a or ("true" if b == "1" else "false" if b else
                          "float" if f else "bf16") for a, b, f, _ in
                    re.findall(r"Li(\d+)E|Lb(\d)E|(f)|(13__nv_bfloat16)",
                               entry.group(2))]
            name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "Used" in line or "spill" in line:
            out.append(f"  {name}: {line.split(':', 1)[-1].strip()}")
        elif "Performance Loss" in line:     # e.g. wgmma serialized, and why
            out.append(f"  {line.split(':', 1)[-1].split(' in the function')[0]}")
    return out


def device_share(torch, what, fn, kernel, top=0):
    """Device busy time of ``fn()`` under ``torch.profiler`` against the
    host's clock around it, and the time of the device events whose name
    holds ``kernel``; with ``top``, the ``top`` device rows by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    own = sum(e.self_device_time_total for e in rows if kernel in e.key) / 1e3
    print(f"  {what}: {wall:.2f} ms wall under torch.profiler, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %; idle "
          f"{100 - 100 * busy / wall:.1f} %), {kernel} kernel {own:.3f} ms, "
          f"{sum(e.count for e in rows)} device events", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        us = e.self_device_time_total
        print(f"    {us / 1e3:9.3f} ms {us / 10 / max(busy, 1e-9):5.1f} %  "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)


def serve_phase(torch, np, dev, seed, hold_flash):
    """Serve llama3.2-1b at full width on the card, twice from one seed.

    Returns what the later phases need: the config, the weights, the first
    2048-token prompt and the flash launches of the first run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers
    from repro_torch.models import transformer as tr
    from repro_torch.serve import Engine

    cfg = get_config("llama3.2-1b")
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.vocab) == (N_LAYERS, D_MODEL, N_HEADS,
                                                   N_KV, HEAD_DIM, VOCAB),
            f"llama3.2-1b config changed: {cfg}")
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(w.numel() * w.element_size() for w in params.parameters())
    print(f"serve: {cfg.name} at its published config ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}); "
          f"{nbytes / 1e9:.3f} GB of weights drawn from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    eng = Engine(cfg, params, block_size=SERVE_BLOCK)
    require(eng.device.type == "cuda", f"engine on {eng.device}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (1, t)) for t in SERVE_PROMPTS]
    max_len = max(t + n - 1 for t, n in zip(SERVE_PROMPTS, SERVE_MAX_NEW,
                                            strict=True))

    def serve_once(what):
        sched = eng.make_scheduler(lanes=SERVE_LANES, max_len=max_len)
        rids = [sched.submit(pr, n) for pr, n in zip(prompts, SERVE_MAX_NEW,
                                                     strict=True)]
        # host clock around each synchronised step; a step that admits no
        # request is one decode step for the lanes active before it
        decode = []                     # (lanes, ms) of the decode-only steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain0 = flash_attention_plain.calls
        reset_launch_counts()
        t0 = time.perf_counter()
        more = True
        while more:
            lanes, prefills = sched.active(), sched.stats["prefills"]
            ts = time.perf_counter()
            more = sched.step()
            torch.cuda.synchronize()
            if sched.stats["prefills"] == prefills:
                decode.append((lanes, (time.perf_counter() - ts) * 1e3))
        done = dict(sched.finished)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        plain = flash_attention_plain.calls - plain0
        peak = torch.cuda.max_memory_allocated()
        toks = [done[r] for r in rids]
        for r, n in zip(toks, SERVE_MAX_NEW, strict=True):
            require(r.shape == (n,), f"{what}: {r.shape[0]} tokens, want {n}")
            require(bool(((r >= 0) & (r < cfg.vocab)).all()),
                    f"{what}: token outside the vocabulary")
        prefills = sched.stats["prefills"]
        require(prefills == len(SERVE_PROMPTS), f"{what}: {prefills} prefills")
        require(sched.stats["admitted_inflight"] > 0,
                f"{what}: no request was admitted mid-stream")
        require(counts == {"modmatmul_batched": 0, "modmatmul": 0,
                           "polyeval": 0,
                           "flash_attention": cfg.n_layers * prefills,
                           "flash_attention_bwd": 0,
                           "rwkv6": 0, "rwkv6_bwd": 0, "ring_fold": 0,
                           "selective_scan": 0, "selective_scan_bwd": 0},
                f"{what}: launch counts {counts}")
        require(plain == 0, f"{what}: {plain} plain attention calls on the card")
        require(fa_mod.flash_attention.lse_launches == 0,
                f"{what}: {fa_mod.flash_attention.lse_launches} serve launches "
                f"wrote the log-sum-exp (a training output)")
        inst = instance_counts()["flash_attention"]
        require(inst == {"wgmma": cfg.n_layers * prefills, "mma_sync": 0,
                         "cuda_core": 0},
                f"{what}: flash_attention instances {inst}")
        require(sched.alloc.used_blocks() == 0, f"{what}: blocks still held")
        require(sched.stats["stalls"] == 0, f"{what}: {sched.stats['stalls']} "
                f"stalls in a pool sized for the worst case")
        print(f"  {what}: {len(rids)} requests, {sum(SERVE_MAX_NEW)} tokens in "
              f"{wall * 1e3:.1f} ms wall; {sched.stats['steps']} decode steps, "
              f"admitted in flight {sched.stats['admitted_inflight']}, "
              f"peak KV blocks {sched.alloc.stats['peak_used']} of "
              f"{sched.alloc.n_blocks - 1}; launches {counts}, flash "
              f"instances {inst}, plain attention calls {plain}", flush=True)
        return dict(toks=toks, counts=counts, wall=wall, decode=decode,
                    peak=peak, pool=sched.pool)

    print(f"serve: Engine on {eng.device}, scheduler with {SERVE_LANES} lanes, "
          f"block size {SERVE_BLOCK}; prompts {list(SERVE_PROMPTS)}, max_new "
          f"{list(SERVE_MAX_NEW)}", flush=True)
    first = serve_once("run 1")
    pool_bytes = sum(x.numel() * x.element_size()
                     for x in (first["pool"].k, first["pool"].v))
    del first["pool"]
    second = serve_once("run 2 (same seed)")
    del second["pool"]
    require(all(np.array_equal(a, b) for a, b in zip(first["toks"],
                                                     second["toks"], strict=True)),
            "serve: a second run from the same seed gave other tokens")
    print("  run 2 tokens equal run 1's", flush=True)

    # time to first token: the model's prefill of one prompt of each length,
    # the call the scheduler makes on admission, on the host clock around a
    # synchronised call, best of 3
    by_len = {}
    for pr in prompts:
        tok = torch.as_tensor(pr, device=dev)
        if tok.shape[1] in by_len:
            continue
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.prefill(cfg, params, tok)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        by_len[tok.shape[1]] = min(runs)
    print("  prefill ms per prompt (host clock around a synchronised call, "
          "best of 3): " + ", ".join(f"T={t}: {ms:.2f}"
                                     for t, ms in sorted(by_len.items())),
          flush=True)
    dec = [ms for _, ms in second["decode"]]
    n_dec = sum(lanes for lanes, _ in second["decode"])
    print(f"  decode (run 2, steps that admitted no request): {len(dec)} steps, "
          f"{sum(dec) / len(dec):.3f} ms mean, {min(dec):.3f} ms min per step "
          f"(up to {SERVE_LANES} lanes); {n_dec} tokens in {sum(dec):.1f} ms = "
          f"{n_dec / sum(dec) * 1e3:.1f} tokens/s; all {sum(SERVE_MAX_NEW)} "
          f"tokens {sum(SERVE_MAX_NEW) / second['wall']:.1f} tokens/s over the "
          f"whole run", flush=True)
    print(f"  weights {nbytes / 2**30:.3f} GiB, KV pool {pool_bytes / 2**30:.3f} "
          f"GiB; peak memory {second['peak'] / 2**30:.3f} GiB "
          f"(max_memory_allocated)", flush=True)

    # the kernel on the q, k, v that layer 0 makes of the first long prompt
    tok0 = torch.as_tensor(prompts[0], device=dev)
    lp = params.layers[0]
    h = layers.rms_norm(params.embed[tok0], lp["attn_norm"], cfg.norm_eps)
    pos = torch.arange(tok0.shape[1], device=dev)[None]
    q, k, v = layers.gqa_project(h, lp, cfg, positions=pos)
    hold_flash(f"layer 0's q, k, v of the first {tok0.shape[1]}-token prompt",
               q, k, v, controls=True)
    del q, k, v, h

    # where a step's time goes: device busy time against the host's clock
    for t in (2048, 128):
        device_share(torch, f"prefill T={t}",
                     lambda t=t: tr.prefill(cfg, params, tok0[:, :t]), "flash")
    sched = eng.make_scheduler(lanes=SERVE_LANES, max_len=max_len)
    for pr in prompts[:SERVE_LANES]:
        sched.submit(pr, 32)
    sched.step()                        # admits all four lanes
    device_share(torch, f"4 decode steps, {SERVE_LANES} lanes busy",
                 lambda: [sched.step() for _ in range(4)], "flash")
    del sched
    return dict(cfg=cfg, params=params, tok0=tok0, counts=first["counts"],
                first_token=int(first["toks"][0][0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every operand and draw (default 0)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.analysis.overflow import (
        certified_k_run,
        certified_window,
    )
    from repro_torch.kernels import (
        _build,
        instance_counts,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import modmatmul as mm_mod
    from repro_torch.kernels.barrett import matmul_folded
    from repro_torch.kernels.flash_attention import (
        agreement,
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.modmatmul import (
        modmatmul,
        modmatmul_batched,
        modmatmul_plain,
    )
    from repro_torch.kernels.polyeval import polyeval, polyeval_plain
    from repro_torch.kernels.ring_fold import ring_fold, ring_fold_plain
    from repro_torch.mpc import (
        P_DEFAULT,
        P_MERSENNE31,
        Field,
        MPCSpec,
        acc_window,
        connect,
    )
    from repro_torch.mpc.tiling import choose_block

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # fp32 products are compared at 2e-5: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    builds = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(builds)} sources in parallel", flush=True)
    for b in builds.values():
        print(f"{b.name}: {b.seconds:.2f} s nvcc -> {os.path.relpath(b.path, ROOT)}")
        for line in ptxas_lines(b.log):
            print(line)

    # ------------------------------------------- kernels vs plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand(p, *shape):
        return torch.randint(0, p, shape, generator=gen, device=dev)

    def full(p, *shape):
        return torch.full(shape, p - 1, dtype=torch.int64, device=dev)

    def compare(what, kern, plain, operands, p, iters=5, want=None, **kw):
        """``kern(*operands, p=p, **kw)`` vs ``plain(*operands, p=p,
        **kw)``: equal (and equal to ``want`` when given); timed when
        ``iters``."""
        got, ref = kern(*operands, p=p, **kw), plain(*operands, p=p, **kw)
        torch.cuda.synchronize()
        require(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} "
                f"!= {tuple(ref.shape)}")
        err = int((got - ref).abs().max()) if got.numel() else 0
        require(torch.equal(got, ref), f"{what}: kernel != plain (max |err| {err})")
        if want is not None:
            require(bool((got == want).all()), f"{what}: != closed form")
        rec = {"max_abs_err": err}
        note = ""
        if iters:
            rec["ms"] = time_ms(torch, lambda: kern(*operands, p=p, **kw), iters)
            rec["plain_ms"] = time_ms(torch, lambda: plain(*operands, p=p, **kw),
                                      iters)
            note = f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms"
        print(f"  {what}: equal{note}", flush=True)
        return rec

    mmb = (modmatmul_batched, modmatmul_plain)
    mm1 = (modmatmul, modmatmul_plain)
    pev = (polyeval, polyeval_plain)

    def instance(name):
        """``modmatmul_batched``'s ``name`` instance through the module's
        private launcher (uncounted), beside the chosen one."""
        return (lambda a, b, p: mm_mod._launch(a, b, p=p, instance=name),
                modmatmul_plain)

    blk = 1024                              # m/t = m/s at m = 2048
    col = blk * blk                         # flattened block: C = (m/t)^2

    def pe_main(p):
        """One block's four polyeval launches, in the forms the stages pass
        them: (what, vand, terms, rows, (N, K, C))."""
        i_pts = rand(p, 17, col)
        alive = torch.sort(torch.randperm(17, generator=gen, device=dev)[:6])[0]
        for ab in "AB":
            yield (f"encode {ab} [17,6] @ [6,{col}]", rand(p, 17, 6),
                   rand(p, 6, col), None, (17, 6, col))
        yield (f"exchange [17,17+2] @ (h [17,{col}], mask [2,{col}])",
               rand(p, 17, 19), (i_pts, rand(p, 2, col)), None, (17, 19, col))
        yield (f"decode [4,6] @ rows {alive.tolist()} of [17,{col}]",
               rand(p, 4, 6), i_pts, alive, (4, 6, col))
    require(mm_mod.choose_instance(17, blk, blk, blk) == "tensor_core"
            and mm_mod.choose_instance(1, blk, blk, blk) == "tensor_core",
            "the main path's or a remote worker's product does not take the "
            "tensor cores")
    rec = {}
    for p in (P_DEFAULT, P_MERSENNE31):
        print(f"kernel checks, p = {p} (acc_window {acc_window(p)}):", flush=True)
        ab = rand(p, 17, blk, blk), rand(p, 17, blk, blk)
        r = compare(f"modmatmul_batched [17,{blk},{blk}]^2 (tensor_core, "
                    f"chosen)", *mmb, ab, p)
        old = compare(f"modmatmul_batched [17,{blk},{blk}]^2 (cuda_core, the "
                      f"earlier instance)", *instance("cuda_core"), ab, p)
        print(f"    tensor_core is {old['ms'] / r['ms']:.2f}x faster than "
              f"cuda_core in this run", flush=True)
        rec[("modmatmul_batched", p)] = dict(
            r, work=mm_work(17, blk, blk, blk, p), instance="tensor_core",
            earlier={"instance": "cuda_core", "ms": old["ms"],
                     "speedup": old["ms"] / r["ms"]})
        for name in ("tensor_core", "cuda_core"):
            compare(f"modmatmul_batched ragged [3,33,65]@[3,65,17] ({name})",
                    *instance(name), (rand(p, 3, 33, 65), rand(p, 3, 65, 17)),
                    p, iters=0)
            compare(f"modmatmul_batched ragged [2,70,130]@[2,130,200] ({name})",
                    *instance(name), (rand(p, 2, 70, 130), rand(p, 2, 130, 200)),
                    p, iters=0)
        # the all-(p-1) corners at the overflow certificates' edges: K = 2
        # windows + 1 for the uint64 accumulators (cuda_core, skinny,
        # polyeval), K = 2 s32 runs + 1 for the tensor cores
        k_win, k_run = 2 * certified_window(p) + 1, 2 * certified_k_run() + 1
        compare(f"modmatmul_batched all-(p-1) corner, K=2*window+1={k_win} "
                f"(chosen)", *mmb,
                (full(p, 4, 256, k_win), full(p, 4, k_win, 64)), p, iters=0,
                want=pow(p - 1, 2, p) * k_win % p)
        require(mm_mod.k_splits(2, 768, k_win, 768, sms)[0] == 1,
                "the cuda_core corner's shape splits K")
        compare(f"modmatmul_batched all-(p-1) corner, K={k_win} (cuda_core, "
                f"one block a tile: every accumulator folds at the window)",
                *instance("cuda_core"),
                (full(p, 2, 768, k_win), full(p, 2, k_win, 768)), p, iters=0,
                want=pow(p - 1, 2, p) * k_win % p)
        compare(f"modmatmul_batched all-(p-1) corner, K={k_win} (cuda_core, "
                f"k_splits {mm_mod.k_splits(4, 256, k_win, 64, sms)[0]})",
                *instance("cuda_core"),
                (full(p, 4, 256, k_win), full(p, 4, k_win, 64)), p, iters=0,
                want=pow(p - 1, 2, p) * k_win % p)
        compare(f"modmatmul_batched all-(p-1) corner, K=2*K_RUN_MAX+1={k_run} "
                f"(tensor_core: three s32 runs)", *instance("tensor_core"),
                (full(p, 2, 64, k_run), full(p, 2, k_run, 64)), p, iters=0,
                want=pow(p - 1, 2, p) * k_run % p)
        compare("modmatmul ragged [33,70]@[70,45]", *mm1,
                (rand(p, 33, 70), rand(p, 70, 45)), p, iters=0)
        pe = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0, "work": (0, 0),
              "launches": []}
        for what, vand, terms, idx, (n, k, c) in pe_main(p):
            r = compare(f"polyeval {what}", *pev, (vand, terms), p, iters=10,
                        rows=idx)
            w = pe_work(n, k, c, p)
            bms = bound(*w)[0]
            print(f"    {r['ms']:.4f} ms against a bound of {bms:.4f} ms "
                  f"(bytes, {w[0] / 1e6:.1f} MB): {100 * bms / r['ms']:.1f} % "
                  f"of the bound", flush=True)
            pe = {"ms": pe["ms"] + r["ms"],
                  "plain_ms": pe["plain_ms"] + r["plain_ms"],
                  "max_abs_err": max(pe["max_abs_err"], r["max_abs_err"]),
                  "work": (pe["work"][0] + w[0], pe["work"][1] + w[1]),
                  "launches": pe["launches"] + [
                      {"launch": what, "ms": r["ms"], "bound_ms": bms}]}
            del vand, terms, idx
        pe_bound = bound(*pe["work"])[0]
        print(f"  polyeval, one block's 4 launches: {pe['ms']:.4f} ms against "
              f"a bound of {pe_bound:.4f} ms ({100 * pe_bound / pe['ms']:.1f} "
              f"% of the bound)", flush=True)
        rec[("polyeval", p)] = pe
        for n, k, c in [(5, 40, 1000), (40, 70, 3333), (1, 1, 5), (70, 9, 777)]:
            compare(f"polyeval ragged [{n},{k}]@[{k},{c}]", *pev,
                    (rand(p, n, k), rand(p, k, c)), p, iters=0)
        compare("polyeval exchange form, odd C: [17,19] @ ([17,1001], [2,1001])",
                *pev, (rand(p, 17, 19), (rand(p, 17, 1001), rand(p, 2, 1001))),
                p, iters=0)
        compare("polyeval decode form, odd C: [4,6] @ rows of [17,3333]", *pev,
                (rand(p, 4, 6), rand(p, 17, 3333)), p, iters=0,
                rows=torch.tensor([1, 4, 5, 9, 13, 16], device=dev))
        shifted = rand(p, 19, 3001)[:, 1:]     # every row 8 bytes off 16
        compare("polyeval rows not 16-byte aligned: [17,19] @ views of one "
                "[19,3001] tensor", *pev,
                (rand(p, 17, 19), (shifted[:17], shifted[17:])), p, iters=0)
        compare(f"polyeval all-(p-1) corner, exchange form, K={k_win}", *pev,
                (full(p, 17, k_win), (full(p, k_win - 2, 1001),
                                      full(p, 2, 1001))), p,
                iters=0, want=pow(p - 1, 2, p) * k_win % p)
        compare(f"polyeval all-(p-1) corner, decode form, K={k_win}", *pev,
                (full(p, 4, k_win), full(p, k_win + 6, 1024)), p, iters=0,
                want=pow(p - 1, 2, p) * k_win % p,
                rows=torch.arange(3, 3 + k_win, device=dev))
        del shifted
        # the remote path's own shapes (phase 6c): each worker's W = 1
        # product and its G row (K = 1), and the dealer's mask term (K = z,
        # one tensor); the encode and decode are pe_main's
        remote = {}
        inst0 = instance_counts()["modmatmul_batched"]
        remote["worker product"] = compare(
            f"remote worker product [1,{blk},{blk}]^2 (tensor_core, W = 1)",
            *mmb, (rand(p, 1, blk, blk), rand(p, 1, blk, blk)), p)
        served = {k: v - inst0[k]
                  for k, v in instance_counts()["modmatmul_batched"].items()}
        require(served["tensor_core"] > 0
                and sum(served.values()) == served["tensor_core"],
                f"remote worker product: instances {served}")
        remote["worker G row"] = compare(
            f"remote worker G row [17,1] @ [1,{col}] (K = 1)", *pev,
            (rand(p, 17, 1), rand(p, 1, col)), p, iters=10)
        remote["dealer mask term"] = compare(
            f"remote dealer mask term [17,2] @ [2,{col}] (K = z)", *pev,
            (rand(p, 17, 2), rand(p, 2, col)), p, iters=10)
        rec[("remote", p)] = remote
        # the sharded path's own shapes (phase 6d), 4 shards of N_pad = 20:
        # a shard's W = 5 product, its encode [5,6] @ [6,C], its exchange
        # [g_mix_t[:, local] | vand_g x 5] @ (h [5,C], masks [10,C]) and one
        # ring hop's fold of a shard's [5,C] chunk, int32 and int64
        sharded = {}
        inst0 = instance_counts()["modmatmul_batched"]
        sharded["shard product"] = compare(
            f"sharded shard product [5,{blk},{blk}]^2 (tensor_core, W = 5)",
            *mmb, (rand(p, 5, blk, blk), rand(p, 5, blk, blk)), p)
        served = {k: v - inst0[k]
                  for k, v in instance_counts()["modmatmul_batched"].items()}
        require(served["tensor_core"] > 0
                and sum(served.values()) == served["tensor_core"],
                f"sharded shard product: instances {served}")
        sharded["shard encode"] = compare(
            f"sharded encode [5,6] @ [6,{col}]", *pev,
            (rand(p, 5, 6), rand(p, 6, col)), p, iters=10)
        sharded["shard exchange"] = compare(
            f"sharded exchange [20,15] @ (h [5,{col}], masks [10,{col}])", *pev,
            (rand(p, 20, 15), (rand(p, 5, col), rand(p, 10, col))), p, iters=10)
        for dt in (torch.int32, torch.int64):
            name = str(dt).split(".")[-1]
            sharded[f"ring_fold {name}"] = compare(
                f"ring_fold {name} [5,{col}] (one shard's chunk, one hop)",
                ring_fold, ring_fold_plain,
                (rand(p, 5, col).to(dt), rand(p, 5, col).to(dt)), p, iters=20)
            compare(f"ring_fold {name} odd C [5,1001]", ring_fold,
                    ring_fold_plain, (rand(p, 5, 1001).to(dt),
                                      rand(p, 5, 1001).to(dt)), p, iters=0)
            compare(f"ring_fold {name} all-(p-1) corner [5,4097] (a + b = "
                    f"2(p-1), its uint32 certificate's edge)", ring_fold,
                    ring_fold_plain, (full(p, 5, 4097).to(dt),
                                      full(p, 5, 4097).to(dt)), p, iters=0,
                    want=p - 2)
        rec[("sharded", p)] = sharded
        del ab
        torch.cuda.empty_cache()

    # the yardstick: cuBLAS's int8 GEMM on the same 16 limb products of one
    # worker product, as [4*1024, 1024] @ [1024, 4*1024] limb stacks, 17
    # times (timed only; the port never calls it).  B is column-major, the
    # layout cuBLASLt's int8 tensor-core kernels take.
    a8 = torch.randint(-128, 128, (4 * blk, blk), generator=gen, device=dev,
                       dtype=torch.int8)
    b8 = torch.randint(-128, 128, (4 * blk, blk), generator=gen, device=dev,
                       dtype=torch.int8).t()
    int8_ms = 17 * time_ms(torch, lambda: torch._int_mm(a8, b8), 20)
    int8_ops = 2 * 17 * 16 * blk**3
    print(f"yardstick: torch._int_mm (cuBLAS int8) on the 16 limb products of "
          f"[17,{blk},{blk}]^2: {int8_ms:.4f} ms = "
          f"{int8_ops / int8_ms / 1e9:.1f} TOP/s ({int8_ops / 1e12:.3f} "
          f"Tops; the bound at 1979 TOP/s is "
          f"{int8_ops / INT8_OPS_PER_S * 1e3:.4f} ms)", flush=True)
    del a8, b8

    # ------------------------------- flash attention vs its plain version
    def hold_flash(what, q, k, v, *, causal=True, q_offset=0, iters=0,
                   library=False, controls=False):
        """The kernel against its plain version on the same operands, within
        ``agreement``'s limits; timed when ``iters``, with the SDPA yardstick
        when ``library``; with ``controls``, two planted faults must fail
        the same check."""
        kw = dict(causal=causal, q_offset=q_offset)
        chosen = fa_mod.choose_instance(q, k, v)
        got = flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == q.dtype,
                f"{what}: {tuple(got.shape)} {got.dtype}")
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        agree = agreement(got, ref)
        require(agree["ok"], f"{what}: kernel ({chosen}) != plain "
                f"({readings(agree)})")
        err = agree["max_abs_err"]
        nbytes, flops, peak = attn_work(q, k, causal, q_offset)
        rec = {"max_abs_err": err, "work": (nbytes, flops), "peak": peak,
               "instance": chosen}
        print(f"  {what} [{chosen}]: {readings(agree)}", flush=True)
        if iters and chosen == "wgmma":
            # the earlier instance on the same operands, held and timed
            def old():
                return fa_mod._launch(q, k, v, instance="mma_sync", **kw)

            a_old = agreement(old(), ref)
            require(a_old["ok"], f"{what}: mma_sync instance != plain "
                    f"({readings(a_old)})")
            rec["earlier"] = {"instance": "mma_sync",
                              "ms": time_ms(torch, old, iters),
                              "device_ms": graph_ms(torch, old, iters),
                              "max_abs_err": a_old["max_abs_err"]}
            print(f"    [mma_sync] {readings(a_old)}", flush=True)
        if controls:
            for fault, bad in planted_faults(q, k, v, ref, **kw):
                a = agreement(bad, ref)
                require(not a["ok"], f"{what}: the check accepts a planted "
                        f"fault ({fault}: {readings(a)})")
                print(f"    control, {fault}: rejected ({readings(a)})",
                      flush=True)
        note = ""
        if iters:
            rec["ms"] = time_ms(torch, lambda: flash_attention(q, k, v, **kw),
                                iters)
            rec["device_ms"] = graph_ms(
                torch, lambda: flash_attention(q, k, v, **kw), iters)
            rec["plain_ms"] = time_ms(
                torch, lambda: flash_attention_plain(q, k, v, **kw), iters)
            bms, by = bound(nbytes, flops, peak)
            note = (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                    f" ms, bound {bms:.4f} ms ({by})")
            note += f" (device time in a CUDA graph {rec['device_ms']:.4f} ms)"
            if "earlier" in rec:
                e = rec["earlier"]
                e["speedup"] = e["ms"] / rec["ms"]
                e["device_speedup"] = e["device_ms"] / rec["device_ms"]
                note += (f", mma_sync instance {e['ms']:.4f} ms, device "
                         f"{e['device_ms']:.4f} ms ({e['speedup']:.2f}x and "
                         f"{e['device_speedup']:.2f}x the time)")
        if library:
            lib = sdpa(q, k, v, causal).transpose(1, 2)
            lib_err = float((lib.float() - ref.float()).abs().max())
            rec["library_ms"] = time_ms(torch, lambda: sdpa(q, k, v, causal),
                                        iters)
            rec["library_device_ms"] = graph_ms(
                torch, lambda: sdpa(q, k, v, causal), iters)
            note += (f", scaled_dot_product_attention {rec['library_ms']:.4f} ms"
                     f", device {rec['library_device_ms']:.4f} ms (max |diff| to "
                     f"plain {lib_err:.3e})")
        if note:
            print(f"    {note}", flush=True)
        return rec

    def flash_case(what, b, t, s, hq, hkv, d, dtype, **kw):
        def draw(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        return hold_flash(what, draw(b, t, hq, d), draw(b, s, hkv, d),
                          draw(b, s, hkv, d), **kw)

    bf16 = torch.bfloat16
    print("flash_attention kernel checks (llama3.2-1b prefill: Hq 32, Hkv 8, "
          "D 64):", flush=True)
    flash_rec = {}
    for t, iters in ((2048, 20), (512, 50)):
        flash_rec[t] = flash_case(
            f"bf16 causal [1,{t},32,64] x [1,{t},8,64]", 1, t, t, N_HEADS,
            N_KV, HEAD_DIM, bf16, iters=iters, library=True, controls=True)
    flash_case("bf16 causal ragged T = S = 1000", 1, 1000, 1000, N_HEADS, N_KV,
               HEAD_DIM, bf16)
    flash_case("bf16 causal T = 128, S = 2048, q_offset = 1920", 1, 128, 2048,
               N_HEADS, N_KV, HEAD_DIM, bf16, q_offset=1920)
    flash_case("bf16 non-causal [2,300,32,64] x [2,700,8,64]", 2, 300, 700,
               N_HEADS, N_KV, HEAD_DIM, bf16, causal=False)
    flash_case("bf16 causal D = 128 [1,300,8,128] x [1,300,2,128]", 1, 300, 300,
               8, 2, 128, bf16)
    flash_case("bf16 causal D = 32 [2,77,4,32] x [2,130,4,32], q_offset = 53",
               2, 77, 130, 4, 4, 32, bf16, q_offset=53)
    fused = torch.randn((1, 700, N_HEADS + 2 * N_KV, HEAD_DIM + 1),
                        generator=gen, device=dev).to(bf16)
    hold_flash("bf16 causal, rows not 16-byte aligned (views of one fused "
               "[1,700,48,65] tensor)", *fused[..., 1:].split(
                   [N_HEADS, N_KV, N_KV], dim=2))
    del fused
    flash_case("fp32 causal [2,96,4,32] x [2,96,1,32]", 2, 96, 96, 4, 1, 32,
               torch.float32)
    flash_case("fp32 non-causal D = 128 [1,200,8,128] x [1,77,2,128]", 1, 200,
               77, 8, 2, 128, torch.float32, causal=False)
    torch.cuda.empty_cache()

    # ------------------------------------------------------- the main path
    spec = MPCSpec(s=2, t=2, z=2)
    m = choose_block(spec.s, spec.t, 1, D_MODEL, VOCAB)
    print(f"main path: connect(MPCSpec(s=2, t=2, z=2)).matmul "
          f"[1,{D_MODEL}] x [{D_MODEL},{VOCAB}]: block m={m}, "
          f"N={spec.n_workers} workers, decode quorum {spec.recovery_threshold}",
          flush=True)
    sess = connect(spec)
    require(sess.device.type == "cuda", f"session on {sess.device}")

    def drive(what, sess, a, b, **kw):
        """One session call with the counters zeroed just before it and
        read just after; checks 63 / 252 launches and 63 blocks."""
        blocks0 = sess.stats["blocks"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        y = sess.matmul(a, b, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        blocks = sess.stats["blocks"] - blocks0
        print(f"  {what}: {wall * 1e3:.1f} ms wall, {blocks} blocks, "
              f"launches {counts}, modmatmul_batched instances "
              f"{instance_counts()['modmatmul_batched']}", flush=True)
        require(blocks == MAIN_BLOCKS, f"{what}: {blocks} blocks != {MAIN_BLOCKS}")
        require(counts == {"modmatmul_batched": MAIN_BLOCKS, "modmatmul": 0,
                           "polyeval": 4 * MAIN_BLOCKS, "flash_attention": 0,
                           "flash_attention_bwd": 0, "rwkv6": 0,
                           "rwkv6_bwd": 0, "ring_fold": 0,
                           "selective_scan": 0, "selective_scan_bwd": 0},
                f"{what}: launch counts {counts}")
        inst = instance_counts()["modmatmul_batched"]
        require(inst == {"tensor_core": MAIN_BLOCKS, "skinny": 0,
                         "cuda_core": 0},
                f"{what}: modmatmul_batched instances {inst}")
        return y, wall, counts

    p = spec.field.p
    a, b = rand(p, 1, D_MODEL), rand(p, D_MODEL, VOCAB)
    want = modmatmul_plain(a, b, p=p)       # exact, limb GEMMs on the card
    host = matmul_folded(a.cpu(), b[:, :512].cpu(), p=p, window=acc_window(p))
    require(torch.equal(want[:, :512].cpu(), host), "plain card product != CPU int64")
    torch.cuda.reset_peak_memory_stats()
    y, _, main_counts = drive("encoded, all 17 workers", sess, a, b, encoded=True)
    require(y.shape == (1, VOCAB) and y.dtype == torch.int64 and y.is_cuda,
            f"result {tuple(y.shape)} {y.dtype} on {y.device}")
    require(torch.equal(y, want), "encoded main path != exact (A @ B) mod p")
    print("  exact in the field: equal to (A @ B) mod p", flush=True)

    alive = np.zeros(spec.n_workers, bool)
    alive[np.random.default_rng(args.seed).choice(
        spec.n_workers, spec.recovery_threshold, replace=False)] = True
    y6, _, _ = drive(f"encoded, decode from workers {np.nonzero(alive)[0].tolist()}",
                     sess, a, b, encoded=True, survivors=alive)
    require(torch.equal(y6, want), "t^2+z survivor decode != exact")

    walls = [drive(f"encoded, timed call {i}", sess, a, b, encoded=True)[1]
             for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    del y, y6, want

    def hold_float(what, logits, h, w):
        """A float call against the float64 product of its operands as the
        field encodes them, ``round(x 2^f)`` (half to even), scaled back by
        ``2^-2f``.  The products and sums are integers far below 2^53, so
        float64 holds them exactly, and the field result is exact while the
        sum stays inside (-p/2, p/2): the two must be equal, bit for bit,
        and pick the same greedy token.  Returns that token."""
        fld = spec.field
        scale = float(fld.scale)
        prod = torch.round(h * scale) @ torch.round(w * scale)
        require(float(prod.abs().max()) < fld.half,
                f"{what}: the fixed-point product leaves (-p/2, p/2)")
        want = prod / scale ** 2
        require(logits.shape == want.shape and bool(torch.isfinite(logits).all()),
                f"{what}: logits malformed")
        diff = float((logits - want).abs().max())
        require(torch.equal(logits, want), f"{what}: != the float64 product of "
                f"the fixed-point operands (max |diff| {diff:.3e})")
        tok, want_tok = int(logits.argmax()), int(want.argmax())
        require(tok == want_tok, f"{what}: greedy token {tok} != {want_tok}")
        plain = h @ w
        print(f"  {what}: equal to the float64 product of the fixed-point "
              f"operands, greedy token {tok} in both; against the unrounded "
              f"float64 product: max |diff| "
              f"{float((logits - plain).abs().max()):.3e}, its greedy token "
              f"{int(plain.argmax())}", flush=True)
        return tok

    h = torch.randn((1, D_MODEL), generator=gen, device=dev, dtype=torch.float64)
    w = 0.02 * torch.randn((D_MODEL, VOCAB), generator=gen, device=dev,
                           dtype=torch.float64)
    logits, float_wall, _ = drive("float h ~ N(0,1), W ~ N(0,0.02)", sess, h, w)
    hold_float("float", logits, h, w)
    del h, w, logits

    m31 = connect(MPCSpec(s=2, t=2, z=2, field=Field(P_MERSENNE31)))
    a31, b31 = rand(P_MERSENNE31, 1, D_MODEL), rand(P_MERSENNE31, D_MODEL, VOCAB)
    y31, _, _ = drive("encoded, Mersenne-31 field", m31, a31, b31, encoded=True)
    require(torch.equal(y31, modmatmul_plain(a31, b31, p=P_MERSENNE31)),
            "M31 main path != exact")
    del a31, b31, y31

    print(f"main path per call: {[round(x * 1e3, 1) for x in walls]} ms wall "
          f"(encoded), {float_wall * 1e3:.1f} ms (float); peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)", flush=True)
    kern_ms = MAIN_BLOCKS * (rec[("modmatmul_batched", p)]["ms"]
                             + rec[("polyeval", p)]["ms"])
    print(f"  kernel time per call ({MAIN_BLOCKS} x (modmatmul_batched + 4 "
          f"polyeval), from the checks above): {kern_ms:.1f} ms = "
          f"{100 * kern_ms / (1e3 * min(walls)):.1f}% of the fastest call",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        sess.matmul(a, b, encoded=True)
        torch.cuda.synchronize()
    # the exchange folds inside polyeval: no torch elementwise pass may touch
    # the [17, 1024^2] I-points (a fold in torch would be add, shifts, and,
    # where)
    big = ([spec.n_workers, col], [spec.n_workers, blk, blk])
    passes = [(e.key, e.count) for e in prof.key_averages(group_by_input_shape=True)
              if elementwise(e.key)
              and any(list(sh) in big for sh in e.input_shapes if sh)]
    print(f"torch elementwise passes over [{spec.n_workers}, {col}] in one call: "
          f"{passes or 'none'}", flush=True)
    require(not passes, f"elementwise torch passes over the I-points: {passes}")
    # device-side rows only (kernels and copies): the operator rows above
    # them carry the same time again
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"device time of one encoded main-path call (torch.profiler): "
          f"{busy / 1e3:.3f} ms in {sum(r[1] for r in rows)} device events")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f} %  "
              f"x{count:<4d} {key[:100]}")

    # ------------------------------------- the tags stage (modmatmul, W=1)
    # the per-share MAC tags of one main-path block, on the same plan
    plan = spec.plan(m)
    i_pts = rand(p, spec.n_workers, blk, blk)
    rvec = rand(p, col)
    offsets = rand(p, spec.n_workers)
    reset_launch_counts()
    tags = plan.stages(dev).tags(i_pts, 12345, offsets, rvec)
    torch.cuda.synchronize()
    tags_counts = launch_counts()
    require(tags_counts == {"modmatmul_batched": 0, "modmatmul": 1,
                            "polyeval": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "rwkv6": 0,
                            "rwkv6_bwd": 0, "ring_fold": 0,
                            "selective_scan": 0, "selective_scan_bwd": 0},
            f"tags stage launch counts {tags_counts}")
    require(instance_counts()["modmatmul"] == {"tensor_core": 0, "skinny": 1,
                                               "cuda_core": 0},
            f"tags stage instances {instance_counts()['modmatmul']}")
    tags_want = (12345 * modmatmul_plain(i_pts.reshape(spec.n_workers, col),
                                         rvec.reshape(col, 1), p=p)[:, 0]
                 + offsets) % p
    require(torch.equal(tags, tags_want), "tags stage != plain")
    print(f"tags stage on the main path's plan: equal to plain, launches "
          f"{tags_counts}", flush=True)
    del i_pts, tags, tags_want
    torch.cuda.empty_cache()

    # ------------------- the batched engine and Byzantine decode (phase 6b)
    rec.update(skinny_checks(torch, dev, gen, sms))
    batched_rec = batched_phase(torch, np, dev, a, b, walls)
    torch.cuda.empty_cache()

    # -------------------- the remote backend over the transport (phase 6c)
    remote_rec = remote_phase(torch, dev, a, b, sess)

    # ------------------------ the sharded backend on a 4-shard mesh (6d)
    sharded_rec = sharded_phase(torch, dev, gen, a, b, hold_float)
    del a, b
    torch.cuda.empty_cache()

    # ------------------------------------------------ serving at full width
    served = serve_phase(torch, np, dev, args.seed, hold_flash)
    cfg, params = served["cfg"], served["params"]

    # ------------------------------- the served model's lm_head under MPC
    from repro_torch.models import transformer as tr

    hidden, _ = tr.forward(cfg, params, served["tok0"])
    h = hidden[0, -1:].double()                      # [1, 2048]
    w = params.embed.T.double().contiguous()         # tied head [2048, 128256]
    logits, _, _ = drive("served hidden state x tied head embed.T", sess, h, w)
    hold_float("private lm_head on the served hidden state", logits, h, w)
    print(f"  the served bf16 prefill's first token was {served['first_token']}",
          flush=True)
    del hidden, h, w, logits

    lm_counts = served["counts"]
    del served, cfg, params
    torch.cuda.empty_cache()

    # ------------------------------------- serving rwkv6-1.6b at full width
    rwkv_rec = rwkv_phase(torch, np, dev, args.seed, gen)

    # ------------------------------------ serving olmoe-1b-7b at full width
    moe_rec = moe_phase(torch, np, dev, args.seed, hold_flash)

    # ------------- the selective scan, jamba-v0.1-52b and whisper-small
    scan_rec = scan_phase(torch, dev, gen, sms)
    jamba_rec = jamba_phase(torch, np, dev, args.seed, hold_flash)
    whisper_rec = whisper_phase(torch, np, dev, args.seed, hold_flash)

    # ------------- the serving command line at full width (launch/serve.py)
    serve_cli_rec = serve_cli_phase(torch, dev, card)

    # ----------- training: the flash backward kernel, then the train phase
    bwd_rec = flash_bwd_phase(torch, dev, gen)
    rbwd_rec = recurrent_bwd_phase(torch, dev, gen, sms)
    train_rec = train_phase(torch, np, dev, args.seed)
    multirank_rec = multirank_phase(torch, np, dev, args.seed, card)

    # ------------------------------------------------------------ report

    meta = {
        "modmatmul_batched": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                              "src/repro/kernels/modmatmul.py:64",
                              main_counts["modmatmul_batched"],
                              f"[17,{blk},{blk}] @ [17,{blk},{blk}]"),
        "polyeval": ("src/repro_torch/kernels/csrc/polyeval.cu",
                     "src/repro/kernels/polyeval.py:33",
                     main_counts["polyeval"],
                     f"one block's 4 launches: [17,6] @ [6,{col}] twice; "
                     f"[17,17+2] @ (h [17,{col}], mask [2,{col}]); [4,6] @ 6 "
                     f"rows of [17,{col}] by index"),
        "modmatmul": ("src/repro_torch/kernels/csrc/modmatmul_skinny.cu",
                      "src/repro/kernels/modmatmul.py:42",
                      batched_rec["skinny_launches"],
                      f"tags: [17,{col}] @ [{col},1] per request; an 8-lane "
                      f"wave's [8,17,{col}] @ [8,{col},1] in one launch"),
    }
    kernels = []
    for name, (source, replaces, launches, shape) in meta.items():
        r = rec[(name, p)]
        bms, by = bound(*r["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shape": shape, "p": p,
            "path": ("verified lm_head (b), 8-lane waves"
                     if name == "modmatmul" else "main path"),
        })
        if name in ("modmatmul_batched", "polyeval"):
            kernels[-1]["remote"] = {
                "path": "remote backend, thread mode, pipelined",
                "launches": remote_rec["launches"][name],
                "blocks": remote_rec["blocks"],
                "launches_per_block": remote_rec["per_block"][name]}
            shapes = ({"worker product": mm_work(1, blk, blk, blk, p)}
                      if name == "modmatmul_batched" else
                      {"worker G row": pe_work(17, 1, col, p),
                       "dealer mask term": pe_work(17, 2, col, p)})
            kernels[-1]["remote"]["shapes"] = {
                what: {"ms": rec[("remote", p)][what]["ms"],
                       "plain_ms": rec[("remote", p)][what]["plain_ms"],
                       "max_abs_err": rec[("remote", p)][what]["max_abs_err"],
                       "bound_ms": bound(*work)[0],
                       "bound_by": bound(*work)[1]}
                for what, work in shapes.items()}
            ring = sharded_rec["ring"]
            kernels[-1]["sharded"] = {
                "path": f"sharded backend, {SHARDS} shards of one card, "
                        f"int32 wire with prg_masks",
                "launches": ring["launches"][name], "blocks": ring["blocks"],
                "launches_per_block": ring["per_block"][name]}
            shapes = ({"shard product": mm_work(5, blk, blk, blk, p)}
                      if name == "modmatmul_batched" else
                      {"shard encode": pe_work(5, 6, col, p),
                       "shard exchange": pe_work(20, 15, col, p)})
            kernels[-1]["sharded"]["shapes"] = {
                what: {"ms": rec[("sharded", p)][what]["ms"],
                       "plain_ms": rec[("sharded", p)][what]["plain_ms"],
                       "max_abs_err": rec[("sharded", p)][what]["max_abs_err"],
                       "bound_ms": bound(*work)[0],
                       "bound_by": bound(*work)[1]}
                for what, work in shapes.items()}
        if name == "modmatmul_batched":
            r31 = rec[(name, P_MERSENNE31)]
            kernels[-1].update({
                "instance": r["instance"], "earlier": r["earlier"],
                "int8_yardstick_ms": int8_ms,
                "m31": {"ms": r31["ms"], "plain_ms": r31["plain_ms"],
                        "bound_ms": bound(*r31["work"])[0],
                        "earlier": r31["earlier"]}})
        elif name == "modmatmul":
            r31 = rec[(name, P_MERSENNE31)]
            wave = rec[("modmatmul_wave", p)]
            kernels[-1].update({
                "instance": "skinny", "earlier": r["earlier"],
                "device_ms": r["device_ms"],
                "m31": {"ms": r31["ms"], "device_ms": r31["device_ms"],
                        "plain_ms": r31["plain_ms"],
                        "bound_ms": bound(*r31["work"])[0],
                        "earlier": r31["earlier"]},
                "wave_8": {"ms": wave["ms"], "device_ms": wave["device_ms"],
                           "plain_ms": wave["plain_ms"],
                           "bound_ms": bound(*wave["work"])[0],
                           "max_abs_err": wave["max_abs_err"]},
                "calls_ms": batched_rec["walls"]})
        else:
            r31 = rec[(name, P_MERSENNE31)]
            kernels[-1].update({
                "per_launch": r["launches"],
                "m31": {"ms": r31["ms"], "plain_ms": r31["plain_ms"],
                        "bound_ms": bound(*r31["work"])[0]}})
    fr = flash_rec[2048]
    bms, by = bound(*fr["work"], fr["peak"])
    small = flash_rec[512]
    small_bound = bound(*small["work"], small["peak"])
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": lm_counts["flash_attention"],
        "max_abs_err": fr["max_abs_err"], "ms": fr["ms"],
        "plain_ms": fr["plain_ms"], "bound_ms": bms, "bound_by": by,
        "library_ms": fr["library_ms"],
        "shape": "bf16 causal q [1,2048,32,64], k and v [1,2048,8,64]",
        "path": "serve prefill", "instance": fr["instance"],
        "device_ms": fr["device_ms"],
        "library_device_ms": fr["library_device_ms"],
        "earlier": fr["earlier"],
        "at_t512": {"ms": small["ms"], "plain_ms": small["plain_ms"],
                    "bound_ms": small_bound[0], "bound_by": small_bound[1],
                    "library_ms": small["library_ms"],
                    "max_abs_err": small["max_abs_err"],
                    "device_ms": small["device_ms"],
                    "library_device_ms": small["library_device_ms"],
                    "earlier": small["earlier"]},
    })
    d128 = bound(*moe_rec["work"], moe_rec["peak"])
    kernels[-1]["at_d128"] = {
        "path": "olmoe-1b-7b serve prefill", "launches": moe_rec["launches"],
        "shape": "bf16 causal q, k and v [1,2048,16,128] (layer 0's)",
        "instance": moe_rec["instance"], "ms": moe_rec["ms"],
        "plain_ms": moe_rec["plain_ms"], "bound_ms": d128[0],
        "bound_by": d128[1], "library_ms": moe_rec["library_ms"],
        "device_ms": moe_rec["device_ms"],
        "library_device_ms": moe_rec["library_device_ms"],
        "max_abs_err": moe_rec["max_abs_err"], "earlier": moe_rec["earlier"]}
    for key, shape, r in (
            ("at_jamba", "bf16 causal q [1,2048,32,128], k and v [1,2048,8,128] "
             "(jamba layer 4's)", jamba_rec),
            ("at_whisper_encoder", "bf16 non-causal q, k and v "
             f"[1,{WHISPER_FRAMES},12,64] (whisper encoder layer 0's)",
             whisper_rec["encoder"]),
            ("at_whisper_cross", f"bf16 non-causal q [1,{whisper_rec['cross_t']},"
             f"12,64], k and v [1,{WHISPER_FRAMES},12,64]",
             whisper_rec["cross"])):
        b_ms, b_by = bound(*r["work"], r["peak"])
        kernels[-1][key] = {
            "shape": shape, "instance": r["instance"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "max_abs_err": r["max_abs_err"]}
    kernels[-1]["at_jamba"]["launches"] = jamba_rec["launches"]
    kernels[-1]["at_jamba"]["path"] = "jamba-v0.1-52b (8 layers) serve prefill"
    kernels[-1]["at_whisper_encoder"]["launches"] = whisper_rec["launches"]
    kernels[-1]["at_whisper_encoder"]["path"] = (
        "whisper-small serve prefill (encoder, decoder self and cross: 36 a "
        "prefill)")
    kernels.append(rwkv_rec)
    r = rec[("sharded", p)]["ring_fold int32"]
    n_fold = 5 * col
    fb, fby = bound(*fold_work(n_fold, 4), FP32_OPS_PER_S)
    r64 = rec[("sharded", p)]["ring_fold int64"]
    kernels.append({
        "name": "ring_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_fold.cu",
        "replaces": "src/repro/mpc/secure_matmul.py:43 (plain JAX in "
                    "mod_ring_reduce_scatter's fori_loop; a port-only kernel)",
        "launches": sharded_rec["ring"]["launches"]["ring_fold"],
        "max_abs_err": max(r["max_abs_err"], r64["max_abs_err"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": fb,
        "bound_by": fby, "library_ms": None,
        "shape": f"int32 [5,{col}]: one shard's chunk at one hop", "p": p,
        "path": f"sharded backend, {SHARDS} shards of one card, int32 wire",
        "int64": {"ms": r64["ms"], "plain_ms": r64["plain_ms"],
                  "bound_ms": bound(*fold_work(n_fold, 8), FP32_OPS_PER_S)[0]},
        "calls": sharded_rec["calls"]})
    served = scan_rec[SCAN_SHAPES[1]]
    b, t = SCAN_SHAPES[1]
    kernels.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/ssm.py:59 (_selective_scan_chunked, plain "
                    "JAX: a lax.scan of lax.associative_scan; a port-only "
                    "kernel)",
        "launches": jamba_rec["scan_launches"],
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"], "library_ms": None,
        "fp32_ops_ms": served["fp32_ops_ms"], "mufu_ms": served["mufu_ms"],
        "instance": "tma", "simple_ms": served["simple_ms"],
        "shape": f"bf16 u, dt [{b},{t},{SCAN_DI}], b, c [{b},{t},{SCAN_N}]; fp32 "
                 f"a, y and state",
        "path": "jamba-v0.1-52b (8 layers) serve prefill: 7 a prefill",
        "other_shapes": {f"{bb}x{tt}": {k: r[k] for k in (
            "ms", "simple_ms", "plain_ms", "bound_ms", "mufu_ms",
            "max_abs_err")}
            for (bb, tt), r in scan_rec.items() if (bb, tt) != (b, t)}})
    main_bwd = bwd_rec[BWD_CASES[0][0]]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:68 (the XLA autodiff of "
                    "attention_chunked, through which the reference trains; "
                    "no Pallas kernel has a backward)",
        "launches": train_rec["llama"]["launches"],
        "max_abs_err": main_bwd["max_abs_err"], "ms": main_bwd["ms"],
        "plain_ms": main_bwd["plain_ms"], "bound_ms": main_bwd["bound_ms"],
        "bound_by": main_bwd["bound_by"], "library_ms": main_bwd["library_ms"],
        "shape": main_bwd["shape"], "instance": main_bwd["instance"],
        "mma_sync_ms": main_bwd.get("mma_sync_ms"),
        "path": f"llama3.2-1b training, {TRAIN_STEPS} steps: 16 a step "
                f"(forward launches {train_rec['llama']['forward_launches']}, "
                f"lse written)",
        "other_shapes": {what: {k: r.get(k) for k in (
            "shape", "instance", "ms", "mma_sync_ms", "plain_ms", "bound_ms",
            "library_ms", "max_abs_err")}
            for what, r in bwd_rec.items() if what != BWD_CASES[0][0]}})
    rtrain = train_rec["recurrent"]
    for name, fwd, arch, rows in (
            ("rwkv6_bwd", "rwkv6", "rwkv6-1.6b",
             "src/repro/kernels/ref.py:58 (the XLA autodiff of rwkv6_chunked, "
             "or of rwkv6_scan_with_state, ref.py:34, through which the "
             "reference trains; no Pallas kernel has a backward)"),
            ("selective_scan_bwd", "selective_scan", "jamba-v0.1-52b",
             "src/repro/models/ssm.py:59 (the XLA autodiff of "
             "_selective_scan_chunked, plain JAX)")):
        r = rbwd_rec[name]
        t_rec = rtrain[arch]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": rows, "launches": t_rec["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"], "rel_frob": r["rel_frob"],
            "autograd_plain_ms": r["autograd_plain_ms"],
            "instance": r["instance"], "sweep_ms": r["sweep_ms"],
            "train_instances": t_rec["instances"][name],
            "path": f"{arch} training ({t_rec['microbatches']} microbatches a "
                    f"step, {len(t_rec['losses'])} steps; forward launches "
                    f"{t_rec['launches'][fwd]})"})
        kernels[-1].update({k: r[k] for k in (
            "forward_ms", "forward_ckpt_ms", "forward_serve_ms", "mufu_ms")
            if k in r})
    llama_train = train_rec["llama"]
    print(json.dumps({"train": {
        "llama3.2-1b": {k: llama_train[k] for k in (
            "step_ms", "tokens_per_s", "peak_gib", "losses", "n_params")},
        "resume": train_rec["resume"], "fp32_cut": train_rec["cut"],
        "whisper-small": train_rec["whisper"],
        **{arch: {k: v for k, v in r.items() if k != "launches"}
           for arch, r in rtrain.items()},
        "phase_s": train_rec["phase_s"]}}))
    print(json.dumps({"jamba": {k: jamba_rec[k] for k in (
        "times", "peak_gib", "n_params", "phase_s")}, "whisper": {
        k: whisper_rec[k] for k in ("times", "peak_gib", "n_params",
                                    "phase_s")}}))
    print(json.dumps({"serve_cli": serve_cli_rec}))
    print(json.dumps({"multirank": multirank_rec}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, the "
          f"kernels' build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

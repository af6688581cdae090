"""The selective scan backward's least time over the device time of its
kernels (either instance and its partial reduce): each launch ``[B /
microbatches, T, Di, N]`` (u, dt, b, c, dy and the checkpoints read once,
du, ddt, db, dc and da written once; 20 fp32 operations a (b, t, d, n) at
67 TFLOP/s)."""
from portbench.harness import work_hybrid as work
from portbench.harness.readers import roofline_pct

PATTERN = (r"\b(ring_bwd_kernel|scan_bwd_kernel|scan_bwd_reduce_kernel|"
           r"tree_reduce_kernel)\b")


def read(ctx):
    n = ctx.counters["launches"].get("selective_scan_bwd", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    b = rows // cfg["train"]["microbatches"]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    nbytes, ops = work.scan_bwd_work(b, seq, di, cfg["mamba_d_state"], elem)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        nbytes, ops, work.FP32_FLOPS_PER_S))

"""The selective scan forward kernel's least time over its device time:
each launch ``[B / microbatches, T, Di, N]`` in the configuration's dtype
(u, dt, b, c read once, the fp32 output and final state written once;
6 fp32 operations a (b, t, d, n) at 67 TFLOP/s), remat's second launches
included; either instance (``tma``, ``simple``) counted."""
from portbench.harness import work_hybrid as work
from portbench.harness.readers import roofline_pct

PATTERN = r"\b(ring_scan_kernel|scan_kernel)\b"


def read(ctx):
    n = ctx.counters["launches"].get("selective_scan", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    b = rows // cfg["train"]["microbatches"]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    nbytes, ops = work.scan_work(b, seq, di, cfg["mamba_d_state"], elem)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        nbytes, ops, work.FP32_FLOPS_PER_S))

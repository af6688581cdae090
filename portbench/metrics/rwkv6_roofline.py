"""The WKV-6 forward kernel's least time over its device time: each launch
``[B / microbatches, T, H, 64]`` in bf16 (r, k, v, w read once, the fp32
output and final state written once; 7 K V flops a step and head at the
bf16 tensor-core rate), remat's second launches included."""
from portbench.harness import work
from portbench.harness.readers import roofline_pct

PATTERN = r"\bwkv_kernel\b"


def read(ctx):
    n = ctx.counters["launches"].get("rwkv6", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    b = rows // cfg["train"]["microbatches"]
    nbytes, flops = work.wkv_work(b, seq, cfg["d_model"] // 64, 2)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        nbytes, flops, work.peak_flops(2)))

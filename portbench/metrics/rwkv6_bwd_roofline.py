"""The WKV-6 backward kernels' least time over their device time: each
launch ``[B / microbatches, T, H, 64]`` in bf16 (r, k, v, w and the fp32
dout read once, dr, dk, dv, dw written once; 10 K V flops a step and head
at the bf16 tensor-core rate), all of ``rwkv6_bwd``'s kernels counted."""
from portbench.harness import work
from portbench.harness.readers import roofline_pct

PATTERN = (r"\b(chunk_product_kernel|chunk_scan_kernel|chunk_grads_kernel|"
           r"scalars_kernel|rows_forward_kernel|cols_reverse_kernel|"
           r"rows_reverse_kernel|du_reduce_kernel)\b")


def read(ctx):
    n = ctx.counters["launches"].get("rwkv6_bwd", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    b = rows // cfg["train"]["microbatches"]
    nbytes, flops = work.wkv_bwd_work(b, seq, cfg["d_model"] // 64, 2)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        nbytes, flops, work.peak_flops(2)))

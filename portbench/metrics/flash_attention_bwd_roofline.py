"""The flash attention backward's least time over the device time of its
kernels (the Δ pass, dK/dV and dQ, any instance): each launch the causal
``[B / microbatches, T, H, hd]`` of the forward (q, k, v, o, dO and lse
read once, dq, dk, dv written once; 10 hd flops a visible pair and head at
the dtype's tensor-core rate)."""
from portbench.harness import work_hybrid as work
from portbench.harness.readers import roofline_pct

PATTERN = (r"\b(dkdv_wgmma_kernel|dq_wgmma_kernel|dkdv_kernel|dq_kernel|"
           r"delta_bf16_kernel|delta_kernel)\b")


def read(ctx):
    n = ctx.counters["launches"].get("flash_attention_bwd", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    hq = cfg["num_attention_heads"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    launch = (rows // cfg["train"]["microbatches"], seq, seq, hq,
              cfg["num_key_value_heads"], cfg["hidden_size"] // hq, elem)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        *work.bwd_work(*launch)))

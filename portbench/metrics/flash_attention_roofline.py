"""The flash attention forward kernel's least time over its device time:
each launch causal self-attention ``[B / microbatches, T, H, hd]`` against
the configuration's kv heads (q, k, v read once, o written once; 4 hd
flops a visible pair and head at the dtype's tensor-core rate), remat's
second launches included; every instance counted."""
from portbench.harness import work_hybrid as work
from portbench.harness.readers import roofline_pct

PATTERN = r"\b(flash_wgmma_kernel|flash_bf16_kernel|flash_fp32_kernel)\b"


def read(ctx):
    n = ctx.counters["launches"].get("flash_attention", 0)
    if not n:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    hq = cfg["num_attention_heads"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    launch = (rows // cfg["train"]["microbatches"], seq, seq, hq,
              cfg["num_key_value_heads"], cfg["hidden_size"] // hq, elem)
    return roofline_pct(ctx, PATTERN, n * work.bound_s(
        *work.attn_work(*launch)))

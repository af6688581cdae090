"""The whole training step's share of the card's bf16 peak: 6 FLOPs per
matmul weight (the head included, the embedding left out) and token, plus
the WKV-6 recurrence forward and backward, at 989 TFLOP/s, over the
untraced rest of the window by the host's clock; remat's recomputation is
not counted."""
from portbench.harness import work


def read(ctx):
    if not ctx.rest_items or ctx.rest_s <= 0:
        return None
    cfg = ctx.config
    rows, seq = ctx.counters["shape"]
    flops = work.rwkv6_step_flops(cfg["d_model"], cfg["d_ff"], cfg["vocab"],
                                  cfg["n_layers"], cfg["decay_lora"],
                                  rows * seq)
    return 100.0 * ctx.rest_items * flops / (work.BF16_FLOPS_PER_S * ctx.rest_s)

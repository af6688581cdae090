"""The whole Jamba training step's share of the card's bf16 peak: 6 FLOPs
per matmul weight and token (the tied head once, the embedding's gather
not at all), plus the causal attention's 12 hd H per visible pair, at 989
TFLOP/s, over the untraced rest of the window by the host's clock; remat's
recomputation and the scans are not counted."""
from portbench.harness import work_hybrid as work


def read(ctx):
    if not ctx.rest_items or ctx.rest_s <= 0:
        return None
    rows, seq = ctx.counters["shape"]
    flops = work.jamba2_step_flops(ctx.config, rows, seq)
    return 100.0 * ctx.rest_items * flops / (work.BF16_FLOPS_PER_S * ctx.rest_s)

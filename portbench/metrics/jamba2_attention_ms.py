"""Device ms a traced step launched inside ``model.attention`` (the
attention sub-blocks' pre-norms, projections and flash forward: their
forward and remat's recompute of it; their gradients run outside any
span)."""
from portbench.harness.spans import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "model.attention")

"""The user's ``r k c`` multiply-adds over the coded block work the session
issued (``m^3`` a block, ``stats["blocks"]`` blocks), over the traced
calls: a count of the shape adapter's padding (``mpc/tiling.py``)."""
from portbench.harness.readers import mpc_blocks


def read(ctx):
    blocks, m = mpc_blocks(ctx)
    if not blocks:
        return None
    r, k, n = ctx.counters["shape"]
    return 100.0 * ctx.items * r * k * n / (blocks * m ** 3)

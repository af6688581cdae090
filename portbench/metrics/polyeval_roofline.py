"""The table products' least time (each block's two phase-1 share
evaluations, the exchange and the decode, each bounded alone; bytes bound
them) over the device time of the ``polyeval`` kernel."""
from portbench.harness import work
from portbench.harness.readers import mpc_blocks, mpc_spec, roofline_pct

PATTERN = r"\bpolyeval_kernel\b"


def read(ctx):
    blocks, m = mpc_blocks(ctx)
    if not blocks:
        return None
    bound = blocks * work.polyeval_block_bound_s(*mpc_spec(ctx), m)
    return roofline_pct(ctx, PATTERN, bound)

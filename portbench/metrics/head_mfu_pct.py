"""The whole private call's share of the card's int8 peak: the paper's
eq. (15) at the user's own ``[r, k] x [k, c]``, summed over the N workers,
9 int8 limb products a residue product, against 1979 TOP/s, over the
untraced rest of the window by the host's clock."""
from portbench.harness import work
from portbench.harness.readers import mpc_spec


def read(ctx):
    if not ctx.rest_items or ctx.rest_s <= 0:
        return None
    r, k, c = ctx.counters["shape"]
    ops = work.private_call_ops(r, k, c, *mpc_spec(ctx))
    return 100.0 * ctx.rest_items * ops / (work.INT8_OPS_PER_S * ctx.rest_s)

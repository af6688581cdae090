"""The worker products' least time over the device time of the
``modmatmul`` family (the tensor-core product and its limb pre-passes):
each block's ``[N x m/t x m/s] @ [m/s x m/t]`` products mod p, 9 int8 limb
products a residue product, against 1979 TOP/s and 3.35 TB/s."""
from portbench.harness import work
from portbench.harness.readers import mpc_blocks, mpc_spec, roofline_pct

PATTERN = r"\b(modmatmul\w*|split_a_kernel|split_bt_kernel)\b"


def read(ctx):
    blocks, m = mpc_blocks(ctx)
    if not blocks:
        return None
    bound = blocks * work.modmatmul_block_bound_s(*mpc_spec(ctx), m)
    return roofline_pct(ctx, PATTERN, bound)

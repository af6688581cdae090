"""Share of the traced window of private calls with no device operation
running, from the device trace alone."""
from portbench.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

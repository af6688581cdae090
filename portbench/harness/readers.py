"""Arithmetic the per-layer metric readers share."""
from __future__ import annotations

from typing import Optional


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced window in which no device operation runs, from
    the trace alone: the device's busy time (operations overlapping
    counted once) over the window the device's own events span."""
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(ctx, pattern: str, bound_s: float) -> Optional[float]:
    """``bound_s``, the least time of the traced stretch's work for one
    kernel family, over the device time of the operations whose names match
    ``pattern``; None where none ran."""
    tr = ctx.trace
    if tr is None:
        return None
    spent = tr.device_s(pattern)
    if spent <= 0:
        return None
    return 100.0 * bound_s / spent


def mpc_blocks(ctx):
    """``(blocks, m)``: the square blocks the session issued in the traced
    stretch (its ``stats["blocks"]``) and their side; ``(0, 0)`` where
    either is unknown."""
    c = ctx.counters
    blocks, m = c.get("blocks", 0), c.get("block_side")
    return (blocks, m) if blocks and m else (0, 0)


def mpc_spec(ctx):
    mpc = ctx.config["mpc"]
    return mpc["s"], mpc["t"], mpc["z"], mpc["n_workers"]


"""The card a run measures, and what it says about itself."""
from __future__ import annotations

import gc
import statistics
import subprocess
import sys

import torch


class NoCard(RuntimeError):
    """The run asks for more CUDA cards than the machine has."""


def require(chips: int) -> torch.device:
    """The first card, after checking that ``chips`` cards are there."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no CUDA card")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell asks for {chips} cards; "
                     f"torch.cuda.device_count() is {have}")
    return torch.device("cuda", 0)


def describe(device: torch.device, chips: int) -> dict:
    """``device`` of the result line: platform, the card's name, the cards
    used and the peak of allocated memory on the card (read once the window
    has closed, before the reference runs)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settle() -> None:
    """The end of set-up: collect the garbage set-up left and freeze what
    survives (``gc.freeze``), so that a collection inside the window does
    not walk the weights', modules' and plans' objects (on the training
    step such a walk took ~250 ms of a ~650 ms step, once or twice a
    window).  Garbage the window makes is collected as before."""
    gc.collect()
    gc.freeze()


def report_times(what: str, seconds: list) -> None:
    """One line on standard error: the window's item times (ms)."""
    ms = sorted(1e3 * s for s in seconds)
    if ms:
        print(f"portbench: {len(ms)} {what}s, ms min {ms[0]:.1f} median "
              f"{statistics.median(ms):.1f} max {ms[-1]:.1f}", file=sys.stderr)


def report_setup(t_start: float, marks: list) -> None:
    """One line on standard error: the seconds each part of set-up took,
    from the process's start (``marks``: ``(name, perf_counter)``)."""
    parts, at = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - at:.2f}")
        at = t
    print("portbench: set-up s: " + ", ".join(parts), file=sys.stderr)

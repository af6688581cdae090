"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` there names the cells).
The program under test is ``repro_torch`` (``src/``); this script puts
``src`` and the checkout root on ``sys.path`` itself.

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from a profiled
stretch at the window's start, with ``busy_s``, ``window_s`` and a
``breakdown``.  Every number compared with the plain reference is printed
beside its limit, as the last lines on standard error and under
``checks``, the result's last key.

Exit codes: 0 with a result; 2 without enough CUDA cards; 3 when a JAX
module (``jax``, ``jaxlib``, ``flax``) or the JAX package (``repro``) is
loaded once the window has closed; anything else is an error.  None but 0
prints a result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """When this process started, on ``time.perf_counter``'s clock (from
    ``/proc``, to a clock tick; the first import's time where there is no
    ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    now = time.perf_counter()
    return min(_T_IMPORT, now - (uptime - ticks / os.sysconf("SC_CLK_TCK")))


def forbidden_modules(names=None) -> list:
    """Modules (default: those loaded) whose top-level name is a JAX
    package's, whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, outcome, trace: bool) -> dict:
    from portbench.harness import cells

    if trace:
        layers = outcome.layers
        metrics = cells.read_layer_metrics(cell, layers)
        device = dict(outcome.device)
        tr = layers.trace
        device["busy_s"] = tr.busy_s if tr is not None else 0.0
        device["window_s"] = tr.window_s if tr is not None else layers.window_s
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in outcome.end_to_end}
        device = outcome.device
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.layers.trace is not None:
        tr = outcome.layers.trace
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return out


def run_cell(root: Path, args, device, t_start: float):
    """Load the cell and run it on ``device``: the part of a run after the
    look for cards (tests drive it on the CPU)."""
    from portbench.harness import cells
    from portbench.harness.outcome import Run

    cell = cells.load_cell(root, args.workload)
    run = Run(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=t_start)
    return cell, cell.kind.run(cell, run)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness import cells, device as hw

    cell = cells.load_cell(ROOT, args.workload)
    try:
        dev = hw.require(cell.chips)
    except hw.NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    cell, outcome = run_cell(ROOT, args, dev, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    line = result_line(cell, outcome, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

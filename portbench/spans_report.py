"""One cell's run with the program's spans on, and what they put down.

    python3 portbench/spans_report.py --workload <name> --seed <n> \
        --seconds <s> --mode <trace|window>

``--mode trace``: the cell's ``--trace 1`` run with the program's spans on
inside the traced stretch (``portbench/harness/spans.py``); prints the
cell's per-layer metrics as ``run.py`` reads them, then under ``spans``
the device ms a traced item launched inside each span and the share of
the traced window idle while the host was inside it, coverage sums, the
launches of the cells' kernels by the span that launched them, the clock
offset and the bounds the marker launches put on it, and the breakdown's
idle gaps named by span; ``spans`` is null where those bounds exclude the
offset.

``--mode window``: the cell's ``--trace 0`` run with the program's spans
on from set-up to the end (the cost of tracing against ``run.py --trace
0``); prints the end-to-end metrics and the spans the run recorded, by
name.

The benchmark's own runs run none of this.  The result is the last line
of standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import types
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the spans each kind of traffic reads, by the metric they would feed
SPANS = {
    "private_matmul": ("mpc.call", "mpc.request", "mpc.block", "mpc.encode",
                       "mpc.worker_compute", "mpc.exchange", "mpc.decode",
                       "mpc.build"),
    "train": ("train.step", "train.forward", "train.backward",
              "train.optimizer", "model.layers", "model.loss",
              "optim.clip_norm", "optim.adamw"),
}
#: the parts whose device time should add up to their whole's
COVER = {
    "private_matmul": ("mpc.call", ("mpc.request", "mpc.encode",
                                    "mpc.worker_compute", "mpc.exchange",
                                    "mpc.decode", "mpc.build")),
    "train": ("train.step", ("train.forward", "train.backward",
                             "train.optimizer")),
}
#: kernels whose launching span is checked: the roofline metrics' own
#: name patterns
KERNELS = {
    "private_matmul": ("modmatmul_roofline", "polyeval_roofline"),
    "train": ("rwkv6_roofline", "rwkv6_bwd_roofline"),
}


def report(at, tr, kind: str, items: int, idle_pct) -> dict:
    """What the attribution ``at`` of ``items`` traced calls or steps
    says, against the trace ``tr`` and the cell's ``idle_pct``; the
    per-span numbers through the metric readers of ``harness/spans.py``."""
    from portbench.harness import spans as hs
    from portbench.harness.cells import load_module

    ctx = types.SimpleNamespace(items=items, spans=at)
    per = {n: {"device_ms": hs.span_device_ms(ctx, n) or 0.0,
               "idle_pct": hs.span_idle_pct(ctx, n) or 0.0,
               "self_idle_pct": 100 * at.self_idle_s(n) / at.window_s}
           for n in SPANS[kind]}
    whole, parts = COVER[kind]
    parts_ms = sum(per[n]["device_ms"] for n in parts)
    outside = 100 * at.idle_s(None) / at.window_s
    phases_idle = sum(per[n]["idle_pct"] for n in parts)
    launches = {m: {p or "(none)": c / items for p, c in at.launches(
        load_module(ROOT, "metrics", m).PATTERN).items()}
                for m in KERNELS[kind]}
    return {
        "items": items, "per_item": per,
        "cover": {"whole": whole, "whole_ms": per[whole]["device_ms"],
                  "parts_ms": parts_ms,
                  "share": parts_ms / per[whole]["device_ms"]
                  if per[whole]["device_ms"] else None,
                  "outside_idle_pct": outside,
                  "parts_idle_pct": phases_idle,
                  "whole_self_idle_pct": per[whole]["self_idle_pct"],
                  "idle_pct": idle_pct,
                  "idle_sum_pct": phases_idle + outside
                  + per[whole]["self_idle_pct"]},
        "unlaunched_ms": at.unlaunched_ns / 1e6 / items,
        "device_total_ms": sum(b - a for a, b, _, _ in at.device)
        / 1e6 / items,
        "launches_per_item": launches,
        "offset_ns": at.offset,
        "offset_bounds_ns": None if at.bounds is None else
        [at.bounds[0] - at.offset, at.bounds[1] - at.offset],
        "spans_per_item": {n: c / items for n, c in Counter(
            r.name for r in at.spans.values()).items()},
        "idle_gaps": at.named_gaps(tr, 10)}


def run(root: Path, workload: str, seed: int, seconds: float, mode: str,
        device, t_start: float) -> dict:
    """One run of ``workload`` in the checkout ``root`` on ``device``, with
    the program's spans on as ``mode`` says; its result line."""
    from portbench import run as bench
    from portbench.harness import cells
    from portbench.harness import spans as hs
    from repro_torch import spans as program

    kind = cells.load_cell(root, workload).kind
    recs = []

    @contextlib.contextmanager
    def keep(enabled):
        with hs.traced(enabled) as rec:
            recs.append(rec)
            yield rec

    trace = mode == "trace"
    plain, kind.traced = kind.traced, keep
    args = bench.parse(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(int(trace))])
    if not trace:
        program.enable()
    try:
        cell, outcome = bench.run_cell(root, args, device, t_start)
    finally:
        program.disable()
        kind.traced = plain
    taken = program.take()
    line = bench.result_line(cell, outcome, trace)
    line["mode"] = mode
    if trace:
        layers = outcome.layers
        idle = next((v["value"] for k, v in line["metrics"].items()
                     if k.startswith("idle_pct.")), None)
        at = hs.attribution(recs[0])
        line["spans"] = None if at is None else report(
            at, layers.trace, cell.traffic["kind"], layers.items, idle)
    else:
        line["spans_recorded"] = dict(Counter(r.name for r in taken.records))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("trace", "window"), required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import run as bench
    from portbench.harness import cells
    from portbench.harness import device as hw

    t_start = bench.process_start()
    dev = hw.require(cells.load_cell(ROOT, args.workload).chips)
    line = run(ROOT, args.workload, args.seed, args.seconds, args.mode, dev,
               t_start)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

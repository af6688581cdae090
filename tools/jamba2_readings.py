"""The readings that the ``jamba2-3b.train_2x8192`` cell's limits are set
from, on the card.

    python3 tools/jamba2_readings.py --seeds 1,2 [--workload NAME] [--out FILE]

``portbench/readings.py``'s training readings (the program's first steps
and a warm step after five more, against the plain reference; the
reference with fp8 products; the reference on half of each batch), for a
cell of the ``train_jamba`` kind, which that command line does not
dispatch.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workload", default="jamba2-3b.train_2x8192")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness import cells, device as hw
    from portbench.readings import train_readings

    cell = cells.load_cell(ROOT, args.workload)
    dev = hw.require(cell.chips)
    what = types.SimpleNamespace(control=True, faults=True, warm_steps=5,
                                 warm_only=False, leaves=False)
    every = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed,
               **train_readings(cell, seed, dev, what),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        every.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(every, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        [--control] [--faults] [--seconds 3] [--warm-steps 5] \
        [--warm-only] [--out FILE]

For each seed, in one process: the program's readings (the numbers the run
compares, against the plain reference), and with ``--control`` the
control's (the reference in a lower precision put in the program's
place), with ``--faults`` each planted fault's.  The benchmark's own runs
run none of this.

* private matmuls: a short window a seed through the cell's traffic kind; the
  control is the reference at ``bfloat16`` and at ``tf32``; the faults
  alter one element of each result where the session produces it, or leave
  out the second half of its rows;
* training: the program's first steps, and a warm step after
  ``--warm-steps`` more, against the reference, with no window; the
  control is the reference with fp8 matrix products; the fault is the
  reference on half of each batch (the mean over the rest).  A step that
  returns its state unchanged reads 1 on ``change_gap`` and needs no run.

Each reading prints as a line of JSON; ``--out`` keeps them all.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Patched:
    """``MPCSession`` stand-in whose ``matmul`` is another computation."""

    def __init__(self, inner, fn):
        self.inner, self.fn = inner, fn
        self.backend, self.stats = inner.backend, inner.stats

    def matmul(self, a, b, **kw):
        return self.fn(a, b, **kw)


def head_variants(cell) -> dict:
    """Session factories for a private-matmul cell's traffic kind: the program,
    the control (the reference in its place, at ``bfloat16`` and at
    ``tf32``) and the planted faults (one element of each result altered by
    one unit of the decode's scale; the second half of each result's rows
    left out; one element altered only where a survivor set decodes)."""
    real = cell.kind._session
    ref = cell.reference()
    mpc = cell.config["mpc"]
    rows = cell.traffic["rows"]
    lsb = 2.0 ** (-2 * mpc["frac_bits"])

    def control(precision):
        def make(cfg, run):
            return _Patched(real(cfg, run), lambda a, b, **kw: ref.product(
                a, b, p=mpc["p"], frac_bits=mpc["frac_bits"],
                precision=precision))
        return make

    def fault(alter, only_survivors=False):
        def make(cfg, run):
            sess = real(cfg, run)

            def matmul(a, b, **kw):
                y = sess.matmul(a, b, **kw)
                if "survivors" in kw or not only_survivors:
                    alter(y)
                return y
            return _Patched(sess, matmul)
        return make

    def altered(y):
        y[0, 0] += lsb

    def half_rows(y):
        y[rows // 2:] = 0

    return {"program": real, "control_bfloat16": control("bfloat16"),
            "control_tf32": control("tf32"), "fault_altered": fault(altered),
            "fault_half_rows": fault(half_rows),
            "fault_survivors": fault(altered, only_survivors=True)}


def run_head(cell, seed, device, seconds, make):
    """One run of the cell's traffic kind with ``make`` as its session
    factory."""
    from portbench.harness.outcome import Run

    kind = cell.kind
    real = kind._session
    kind._session = make
    try:
        return kind.run(cell, Run(seed=seed, seconds=seconds, trace=False,
                                  device=device, t_start=time.perf_counter()))
    finally:
        kind._session = real


def head_readings(cell, seed, device, args):
    variants = head_variants(cell)
    names = ["program"]
    if args.control:
        names += ["control_bfloat16", "control_tf32"]
    if args.faults:
        names += ["fault_altered", "fault_half_rows", "fault_survivors"]
    return {n: {c.name: c.value for c in run_head(
        cell, seed, device, args.seconds, variants[n]).checks} for n in names}


def _worst(prog, ref, key, k=4):
    import statistics

    want, got = ref[key], prog[key]
    med = statistics.median(want.values())
    gaps = sorted(((abs(got[n] - want[n]) / max(want[n], med, 1e-30), n)
                   for n in want), reverse=True)[:k]
    return {"median": med, "worst": [
        [n, g, got[n], want[n]] for g, n in gaps]}


def train_readings(cell, seed, device, args):
    """The first steps' numbers and the warm step's (after
    ``--warm-steps`` more steps), for the program and, as asked, the
    control and the half-batch fault."""
    tk = cell.kind
    trainer = tk.Trainer(cell, seed, device)
    prog = trainer.first_steps()
    n0 = cell.traffic["check_steps"]
    for i in range(n0, n0 + args.warm_steps):
        trainer.step(i)
    warm = trainer.warm_step(n0 + args.warm_steps)
    trainer.free()
    half = slice(0, cell.traffic["global_batch"] // 2)
    ref_warm = trainer.warm_reference()
    out = {"program_warm": tk.compare_warm(warm, ref_warm),
           "warm_leaves": _worst(warm, ref_warm, "grad_norms")}
    if args.control:
        out["control_fp8_warm"] = tk.compare_warm(
            trainer.warm_reference(precision="fp8"), ref_warm)
    if args.faults:
        out["fault_half_batch_warm"] = tk.compare_warm(
            trainer.warm_reference(rows=half), ref_warm)
    trainer.drop_before()
    if args.warm_only:
        return out
    ref = trainer.reference()
    out.update({"program": tk.compare(prog, ref),
                "losses": [prog["losses"], ref["losses"]],
                "grad_leaves": _worst(prog, ref, "grad_norms"),
                "change_leaves": _worst(prog, ref, "change_norms")})
    if args.leaves:
        out["all_leaves"] = {k: [prog[k], ref[k]]
                             for k in ("grad_norms", "change_norms")}
    if args.control:
        out["control_fp8"] = tk.compare(trainer.reference(precision="fp8"),
                                        ref)
    if args.faults:
        out["fault_half_batch"] = tk.compare(trainer.reference(rows=half),
                                             ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--leaves", action="store_true",
                    help="keep every leaf's norms (training)")
    ap.add_argument("--warm-steps", type=int, default=5,
                    help="steps between the checked ones and the warm step "
                         "(training)")
    ap.add_argument("--warm-only", action="store_true",
                    help="read the warm step alone (training)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness import cells, device as hw

    cell = cells.load_cell(ROOT, args.workload)
    dev = hw.require(cell.chips)
    kind = cell.traffic["kind"]
    fn = {"private_matmul": head_readings, "train": train_readings}[kind]
    every = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed,
               **fn(cell, seed, dev, args),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        every.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(every, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

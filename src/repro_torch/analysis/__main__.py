"""``python -m repro_torch.analysis`` — the port's three-pass static gate.

Port of ``python -m repro.analysis``.  Runs the overflow verifier (both
shipped primes, the port's full tuner space, every CUDA accumulator), the
device-stream lint over the given paths, and the protocol-invariant
prover; exits 1 on any unsuppressed, non-baselined finding::

    PYTHONPATH=src python -m repro_torch.analysis

Options::

    paths                  files/dirs to lint (default: src/repro_torch)
    --baseline FILE        accepted-debt fingerprints (see report.py)
    --write-baseline FILE  regenerate the baseline from current findings
    --passes P[,P...]      subset of overflow,jitlint,invariants
    --rules R[,R...]       subset of jitlint rules
    --max-m N              block-side bound for the spec-space proof
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from ..mpc.field import P_DEFAULT, P_MERSENNE31
from . import invariants, jitlint, overflow
from .report import (Finding, diff_baseline, load_baseline, summarize,
                     write_baseline)

PASSES = ("overflow", "jitlint", "invariants")
DEFAULT_PATHS = ["src/repro_torch"]


def _overflow_findings(max_m: int) -> List[Finding]:
    anchor = "src/repro_torch/analysis/overflow.py"
    out: List[Finding] = []
    try:
        certs = overflow.self_check()
        print(f"[overflow] certified K-run {certs['k_run']} "
              f"(modmatmul_tc.cu's s32 diagonals)")
        for p in (P_DEFAULT, P_MERSENNE31):
            pipe = overflow.verify_field_pipeline(p)
            stats = overflow.verify_spec_space(p, max_m=max_m)
            print(f"[overflow] p={p}: {pipe['obligations']} pipeline "
                  f"obligations, {stats['configs']} tuner configs, "
                  f"{stats['distinct_proofs']} distinct obligations, "
                  f"certified window={certs['window'][p]}")
    except overflow.OverflowProofError as e:
        out.append(Finding(rule="overflow", file=anchor, line=1,
                           message=str(e), snippet=str(e)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--write-baseline", default=None)
    ap.add_argument("--passes", default=",".join(PASSES))
    ap.add_argument("--rules", default=",".join(jitlint.RULES))
    ap.add_argument("--max-m", type=int, default=256)
    args = ap.parse_args(argv)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    bad = set(passes) - set(PASSES)
    if bad:
        ap.error(f"unknown pass(es) {sorted(bad)}; choose from {PASSES}")
    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    paths = args.paths or DEFAULT_PATHS

    findings: List[Finding] = []
    if "overflow" in passes:
        findings += _overflow_findings(args.max_m)
    if "jitlint" in passes:
        lint = jitlint.lint_paths(paths, rules)
        print(f"[jitlint] {len(lint)} unsuppressed finding(s) over "
              f"{', '.join(paths)} ({summarize(lint)})")
        findings += lint
    if "invariants" in passes:
        try:
            stats = invariants.run()
        except invariants.InvariantProofError as e:
            findings.append(Finding(rule="invariant", file="src", line=1,
                                    message=str(e), snippet=str(e)))
        else:
            print(f"[invariants] {sum(stats.values())} obligations proven "
                  + ", ".join(f"{k}={v}" for k, v in stats.items()))

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"[baseline] wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    fresh = diff_baseline(findings, baseline)
    if args.baseline:
        print(f"[baseline] {len(findings) - len(fresh)} finding(s) absorbed "
              f"by {args.baseline}")
    for f in fresh:
        print(f.render())
    if fresh:
        print(f"FAILED: {len(fresh)} new finding(s) ({summarize(fresh)}); "
              f"fix, or `# analysis: allow(<rule>): reason`")
        return 1
    print("OK: no unsuppressed findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time rwkv6-1.6b's train step of two source trees in one run.

    python3 tools/rwkv_train_ab.py PARENT_ROOT [--steps 6] [--rounds 1]

``PARENT_ROOT`` is the root of another checkout (for example a ``git
archive`` of the parent commit unpacked under ``build/``).  Each tree's
step runs in a process of its own, with that tree's ``src`` first on the
path and its kernels built into its own ``build/kernels``, in the order
parent, this tree, this tree, parent, ``--rounds`` times.  A process
builds rwkv6-1.6b at its published width (24 layers, bf16, weights from
seed 0) with its ``ARCH_TRAIN_OVERRIDES`` (2 microbatches, fp32 AdamW),
runs one step to warm up, then ``--steps`` steps on one batch of 4 x 2048
tokens, each synchronised, and reports the wall ms of each step, the
losses and the ``rwkv6_bwd`` launches.  Prints the card's name and power
limit first.  Needs a CUDA card and ``nvcc``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 4, 2048


def worker(root, steps):
    """One tree's steps; prints one JSON line."""
    sys.path.insert(0, os.path.join(root, "src"))
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.step import (
        ARCH_TRAIN_OVERRIDES,
        init_train_state,
        make_train_step,
    )

    cfg = get_config("rwkv6-1.6b")
    tc = dataclasses.replace(ARCH_TRAIN_OVERRIDES[cfg.name], peak_lr=3e-4,
                             warmup=0, stable=10_000, decay=1_000,
                             seq_chunk=512)
    dev = torch.device("cuda")
    params, opt_state = init_train_state(cfg, tc, 0, device=dev)
    step_fn = make_train_step(cfg, tc)
    tokens = SyntheticTokens(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                             seed=0)
    batch = tokens.batch(0, device=dev)
    params, opt_state, metrics = step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"root": root, "step_ms": ms, "losses": losses,
                      "rwkv6_bwd": launch_counts()["rwkv6_bwd"]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_root", nargs="?")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.steps)
        return 0
    if args.parent_root is None:
        ap.error("PARENT_ROOT is required")

    import torch

    if not torch.cuda.is_available():
        print("rwkv_train_ab: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"parent": os.path.abspath(args.parent_root), "this": ROOT}
    runs = {name: [] for name in trees}
    for _ in range(args.rounds):
        for name in ("parent", "this", "this", "parent"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 trees[name], "--steps", str(args.steps)],
                capture_output=True, text=True, cwd=trees[name])
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            runs[name].append(rec)
            print(f"{name}: step ms {[round(x, 1) for x in rec['step_ms']]}, "
                  f"losses {[round(x, 4) for x in rec['losses']]}, "
                  f"rwkv6_bwd launches {rec['rwkv6_bwd']}", flush=True)
    summary = {}
    for name, recs in runs.items():
        steps = sorted(x for rec in recs for x in rec["step_ms"])
        summary[name] = {"min_ms": steps[0],
                         "median_ms": steps[len(steps) // 2],
                         "steps": len(steps)}
    print(json.dumps({"rwkv6-1.6b train step": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Closed-loop private matmuls: one caller, one ``MPCSession.matmul`` at a
time, fresh left operands every call against one fixed right operand.

Traffic parameters (``portbench/traffic/<name>.json``, ``"kind":
"private_matmul"``): ``rows`` a call; ``warmup_calls``; ``trace_calls``,
the calls at the window's start that a ``--trace 1`` run profiles;
``check_calls`` and ``check_span``, how many calls' results the
correctness check keeps (the first call and the rest drawn from the seed
below ``check_span``).  Once the window has closed, one kept call is made
again and decoded from ``t^2 + z`` workers drawn from the seed; it has to
equal the reference too.

Configuration keys read: ``hidden_size`` (k), ``vocab_size`` (c),
``initializer_range`` (the right operand's standard deviation), ``mpc``
(``scheme``, ``s``, ``t``, ``z``, ``n_workers``, ``p``, ``frac_bits``,
``backend``), ``limits`` (``max_abs_err``, ``max_abs_err_survivors``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import device as hw
from portbench.harness import traffic as gen
from portbench.harness.outcome import (
    Check,
    LayerContext,
    Outcome,
    Run,
    nearest_rank,
)
from portbench.harness.trace import traced

# calls inside set-up draw their operands at indices past any window's
WARMUP_BASE = 1 << 40


def _session(cfg: dict, run: Run):
    from repro_torch.mpc import Field, MPCSpec, connect

    mpc = cfg["mpc"]
    spec = MPCSpec(s=mpc["s"], t=mpc["t"], z=mpc["z"], scheme=mpc["scheme"],
                   field=Field(p=mpc["p"], frac_bits=mpc["frac_bits"]))
    if spec.n_workers != mpc["n_workers"]:
        raise ValueError(f"the program's code has {spec.n_workers} workers; "
                         f"the configuration states {mpc['n_workers']}")
    return connect(spec, backend=mpc["backend"], device=run.device,
                   key=gen.subseed(run.seed, "head", 1))


def block_side(mpc: dict, r: int, k: int, c: int, blocks: int,
               calls: int):
    """The side ``m`` of the square blocks the session tiled each call
    into, by the program's tiling rule (``mpc/tiling.py``), where its grid
    accounts for every block the session counted; else None."""
    from repro_torch.mpc.tiling import choose_block

    m = choose_block(mpc["s"], mpc["t"], r, k, c)
    grid = (-(-r // m)) * (-(-k // m)) * (-(-c // m))
    return m if calls and grid * calls == blocks else None


def survivors(seed: int, mpc: dict) -> np.ndarray:
    """A decode mask of ``t^2 + z`` of the N workers, drawn from the seed:
    the fewest the configuration says any result decodes from."""
    rng = np.random.default_rng(gen.subseed(seed, "sample", 1))
    alive = np.zeros(mpc["n_workers"], bool)
    alive[rng.choice(mpc["n_workers"], mpc["t"] ** 2 + mpc["z"],
                     replace=False)] = True
    return alive


def run(cell, run: Run) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = run.device
    rows, k, c = tr["rows"], cfg["hidden_size"], cfg["vocab_size"]
    marks = [("imports", time.perf_counter())]
    head = gen.normal((k, c), run.seed, "head", 0, dev,
                      std=cfg["initializer_range"])
    sess = _session(cfg, run)
    marks.append(("head and session", time.perf_counter()))

    def call(index):
        a = gen.hidden_states(run.seed, index, rows, k, dev)
        t0 = time.perf_counter()
        y = sess.matmul(a, head)
        hw.synchronize(dev)
        if y.shape != (rows, c) or y.dtype != torch.float32:
            raise ValueError(f"a private call returned {tuple(y.shape)} "
                             f"{y.dtype}, not [{rows}, {c}] float32")
        return y, time.perf_counter() - t0

    for j in range(tr["warmup_calls"]):
        call(WARMUP_BASE + j)
    marks.append(("warm-up calls", time.perf_counter()))
    # the checked calls' results are copied into buffers made now, so that
    # keeping them allocates nothing in the window
    keep = {i: torch.empty((rows, c), dtype=torch.float32, device=dev)
            for i in gen.sample(run.seed, tr["check_calls"], tr["check_span"])}
    kept, lat = {}, []

    from repro_torch.kernels import launch_counts

    layers = None
    hw.settle()
    t_window = time.perf_counter()
    setup_s = t_window - run.t_start
    hw.report_setup(run.t_start, marks + [("settle", t_window)])
    with traced(run.trace) as rec:
        before, blocks0 = launch_counts(), sess.stats["blocks"]
        t0 = time.perf_counter()
        for i in range(tr["trace_calls"] if run.trace else 0):
            y, dt = call(i)
            lat.append(dt)
            if i in keep:
                kept[i] = keep[i].copy_(y)
        traced_s = time.perf_counter() - t0
        after, blocks1 = launch_counts(), sess.stats["blocks"]
    t_rest = time.perf_counter()
    if run.trace:
        blocks = blocks1 - blocks0
        layers = dict(items=len(lat), window_s=traced_s,
                      counters={"launches": {n: after[n] - before[n]
                                             for n in after},
                                "blocks": blocks,
                                "block_side": block_side(cfg["mpc"], rows, k,
                                                         c, blocks, len(lat)),
                                "shape": (rows, k, c)})
    i = len(lat)
    while time.perf_counter() - t_window < run.seconds:
        y, dt = call(i)
        lat.append(dt)
        if i in keep:
            kept[i] = keep[i].copy_(y)
        i += 1
    t_end = time.perf_counter()
    window_s = t_end - t_window
    hw.report_times("call", lat)
    device = hw.describe(dev, cell.chips)
    if layers is not None:
        layers = LayerContext(config=cfg, traffic=tr, trace=rec.trace,
                              rest_items=len(lat) - layers["items"],
                              rest_s=t_end - t_rest, **layers)
    # one kept call again, decoded from the fewest workers the
    # configuration says suffice, a set drawn from the seed
    mpc = cfg["mpc"]
    again, few = None, None
    if kept:
        again = sorted(kept)[gen.subseed(run.seed, "sample", 2) % len(kept)]
        few = sess.matmul(gen.hidden_states(run.seed, again, rows, k, dev),
                          head, survivors=survivors(run.seed, mpc))
    del sess, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference, once the window has closed and the program's
    # state is freed
    ref = cell.reference()
    errs, worst_few = [], float("nan")
    for idx, got in sorted(kept.items()):
        a = gen.hidden_states(run.seed, idx, rows, k, dev)
        want = ref.product(a, head, p=mpc["p"], frac_bits=mpc["frac_bits"])
        errs.append(float((got - want).abs().max()))
        if idx == again:
            worst_few = float((few - want).abs().max())
    # NaN stays NaN, and no result at all reads NaN
    worst = float(torch.tensor(errs or [float("nan")]).max())
    limits = cfg["limits"]
    checks = [Check("max_abs_err", worst, limits["max_abs_err"]),
              Check("max_abs_err_survivors", worst_few,
                    limits["max_abs_err_survivors"])]
    n = len(lat)
    e2e = {"private_rows_per_s": rows * n / window_s,
           "private_call_p95_ms": 1e3 * nearest_rank(lat, 0.95),
           "setup_s": setup_s}
    return Outcome(attempted=n, failed=0, end_to_end=e2e, checks=checks,
                   device=device, layers=layers)

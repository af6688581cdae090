#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (``nvidia-smi``); exits non-zero
   when there is no card.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, all at once) and prints the
   build time and ``-Xptxas -v``'s registers, shared memory and spills.
3. Holds every kernel against its plain version on the card
   (``torch.equal``) for both primes, at the main path's shapes, a ragged
   shape and the all-(p-1) corner, and times both with CUDA events.
4. Runs the main path: a full-width lm_head projection
   ``[1, 2048] x [2048, 128256]`` (llama3.2-1b's hidden size and
   vocabulary) through ``connect(MPCSpec(s=2, t=2, z=2)).matmul`` on the
   card; checks it exact in the field, from all 17 workers and from only
   t^2+z = 6 of them, and within the fixed-point bound on floats; checks
   from the launch counters that every product ran in the kernels.
   A ``torch.profiler`` table of one more call shows where its device time
   goes.
5. Drives the ``tags`` stage (the W = 1 ``modmatmul``) on the main path's
   plan.
6. Prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises and the script exits non-zero.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): HBM rate and int8 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

D_MODEL, VOCAB = 2048, 128256      # llama3.2-1b: hidden size, vocabulary
MAIN_BLOCKS = 63                   # choose_block(2, 2, 1, 2048, 128256) -> m = 2048


class SmokeFailure(RuntimeError):
    """A check of this script did not hold."""


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def limbs(p):
    """7-bit limbs per field element under the int8 tensor-core schedule."""
    return -(-p.bit_length() // 7)


def bound(nbytes, ops):
    """(ms, 'bytes'|'operations'): the least time an H100 could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mm_work(w, m, k, n, p):
    return 8 * w * (m * k + k * n + m * n), 2 * w * m * k * n * limbs(p) ** 2


def pe_work(n, k, c, p):
    return 8 * (n * k + k * c + n * c), 2 * n * k * c * limbs(p) ** 2


def time_ms(torch, fn, iters):
    """Mean device time of one call over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ptxas_lines(log):
    """``-Xptxas -v`` usage lines, each under its kernel's short name."""
    out, name = [], "?"
    for line in log.splitlines():
        entry = re.search(r"\d((?:[a-z]+_)*kernel)I?((?:Li\d+E)*)", line)
        if entry and "Compiling entry" in line:
            args = re.findall(r"\d+", entry.group(2))
            name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "Used" in line or "spill" in line:
            out.append(f"  {name}: {line.split(':', 1)[-1].strip()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every operand and draw (default 0)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.barrett import matmul_folded
    from repro_torch.kernels.modmatmul import (
        k_splits,
        modmatmul,
        modmatmul_batched,
        modmatmul_plain,
    )
    from repro_torch.kernels.polyeval import polyeval, polyeval_plain
    from repro_torch.mpc import (
        P_DEFAULT,
        P_MERSENNE31,
        Field,
        MPCSpec,
        acc_window,
        connect,
    )
    from repro_torch.mpc.tiling import choose_block

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    builds = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(builds)} sources in parallel", flush=True)
    for b in builds.values():
        print(f"{b.name}: {b.seconds:.2f} s nvcc -> {os.path.relpath(b.path, ROOT)}")
        for line in ptxas_lines(b.log):
            print(line)

    # ------------------------------------------- kernels vs plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand(p, *shape):
        return torch.randint(0, p, shape, generator=gen, device=dev)

    def full(p, *shape):
        return torch.full(shape, p - 1, dtype=torch.int64, device=dev)

    def compare(what, kern, plain, operands, p, iters=5, want=None):
        """``kern(*operands, p=p)`` vs ``plain(*operands, p=p)``: equal
        (and equal to ``want`` when given); timed when ``iters``."""
        got, ref = kern(*operands, p=p), plain(*operands, p=p)
        torch.cuda.synchronize()
        require(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} "
                f"!= {tuple(ref.shape)}")
        err = int((got - ref).abs().max()) if got.numel() else 0
        require(torch.equal(got, ref), f"{what}: kernel != plain (max |err| {err})")
        if want is not None:
            require(bool((got == want).all()), f"{what}: != closed form")
        rec = {"max_abs_err": err}
        note = ""
        if iters:
            rec["ms"] = time_ms(torch, lambda: kern(*operands, p=p), iters)
            rec["plain_ms"] = time_ms(torch, lambda: plain(*operands, p=p), iters)
            note = f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms"
        print(f"  {what}: equal{note}", flush=True)
        return rec

    mmb = (modmatmul_batched, modmatmul_plain)
    mm1 = (modmatmul, modmatmul_plain)
    pev = (polyeval, polyeval_plain)
    blk = 1024                              # m/t = m/s at m = 2048
    col = blk * blk                         # flattened block: C = (m/t)^2
    main_pe = [(17, 6, col), (17, 6, col), (17, 17, col), (17, 2, col),
               (4, 6, col)]                 # encode A, B; G-mix; mask; decode
    rec = {}
    for p in (P_DEFAULT, P_MERSENNE31):
        print(f"kernel checks, p = {p} (acc_window {acc_window(p)}):", flush=True)
        ab = rand(p, 17, blk, blk), rand(p, 17, blk, blk)
        r = compare(f"modmatmul_batched [17,{blk},{blk}]^2", *mmb, ab, p)
        rec[("modmatmul_batched", p)] = dict(r, work=mm_work(17, blk, blk, blk, p))
        compare("modmatmul_batched ragged [3,33,65]@[3,65,17]", *mmb,
                (rand(p, 3, 33, 65), rand(p, 3, 65, 17)), p, iters=0)
        compare("modmatmul_batched all-(p-1) corner, K=3000", *mmb,
                (full(p, 4, 256, 3000), full(p, 4, 3000, 64)), p, iters=0,
                want=pow(p - 1, 2, p) * 3000 % p)
        # W = 1 at the tags stage's shape on the main path's plan
        r = compare(f"modmatmul [17,{col}]@[{col},1] (tags), K split "
                    f"{k_splits(1, 17, col, 1, sms)}", *mm1,
                    (rand(p, 17, col), rand(p, col, 1)), p)
        rec[("modmatmul", p)] = dict(r, work=mm_work(1, 17, col, 1, p))
        compare("modmatmul ragged [33,70]@[70,45]", *mm1,
                (rand(p, 33, 70), rand(p, 70, 45)), p, iters=0)
        pe = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0, "work": (0, 0)}
        for n, k, c in main_pe:
            r = compare(f"polyeval [{n},{k}]@[{k},{c}]", *pev,
                        (rand(p, n, k), rand(p, k, c)), p)
            w = pe_work(n, k, c, p)
            pe = {"ms": pe["ms"] + r["ms"],
                  "plain_ms": pe["plain_ms"] + r["plain_ms"],
                  "max_abs_err": max(pe["max_abs_err"], r["max_abs_err"]),
                  "work": (pe["work"][0] + w[0], pe["work"][1] + w[1])}
        rec[("polyeval", p)] = pe
        for n, k, c in [(5, 40, 1000), (40, 70, 3333), (1, 1, 5)]:
            compare(f"polyeval ragged [{n},{k}]@[{k},{c}]", *pev,
                    (rand(p, n, k), rand(p, k, c)), p, iters=0)
        compare("polyeval all-(p-1) corner, K=9", *pev,
                (full(p, 17, 9), full(p, 9, 4096)), p, iters=0,
                want=pow(p - 1, 2, p) * 9 % p)
        del ab
        torch.cuda.empty_cache()

    # ------------------------------------------------------- the main path
    spec = MPCSpec(s=2, t=2, z=2)
    m = choose_block(spec.s, spec.t, 1, D_MODEL, VOCAB)
    print(f"main path: connect(MPCSpec(s=2, t=2, z=2)).matmul "
          f"[1,{D_MODEL}] x [{D_MODEL},{VOCAB}]: block m={m}, "
          f"N={spec.n_workers} workers, decode quorum {spec.recovery_threshold}",
          flush=True)
    sess = connect(spec)
    require(sess.device.type == "cuda", f"session on {sess.device}")

    def drive(what, sess, a, b, **kw):
        """One session call with the counters zeroed just before it and
        read just after; checks 63 / 315 launches and 63 blocks."""
        blocks0 = sess.stats["blocks"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        y = sess.matmul(a, b, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        blocks = sess.stats["blocks"] - blocks0
        print(f"  {what}: {wall * 1e3:.1f} ms wall, {blocks} blocks, "
              f"launches {counts}", flush=True)
        require(blocks == MAIN_BLOCKS, f"{what}: {blocks} blocks != {MAIN_BLOCKS}")
        require(counts == {"modmatmul_batched": MAIN_BLOCKS, "modmatmul": 0,
                           "polyeval": 5 * MAIN_BLOCKS},
                f"{what}: launch counts {counts}")
        return y, wall, counts

    p = spec.field.p
    a, b = rand(p, 1, D_MODEL), rand(p, D_MODEL, VOCAB)
    want = modmatmul_plain(a, b, p=p)       # exact, limb GEMMs on the card
    host = matmul_folded(a.cpu(), b[:, :512].cpu(), p=p, window=acc_window(p))
    require(torch.equal(want[:, :512].cpu(), host), "plain card product != CPU int64")
    torch.cuda.reset_peak_memory_stats()
    y, _, main_counts = drive("encoded, all 17 workers", sess, a, b, encoded=True)
    require(y.shape == (1, VOCAB) and y.dtype == torch.int64 and y.is_cuda,
            f"result {tuple(y.shape)} {y.dtype} on {y.device}")
    require(torch.equal(y, want), "encoded main path != exact (A @ B) mod p")
    print("  exact in the field: equal to (A @ B) mod p", flush=True)

    alive = np.zeros(spec.n_workers, bool)
    alive[np.random.default_rng(args.seed).choice(
        spec.n_workers, spec.recovery_threshold, replace=False)] = True
    y6, _, _ = drive(f"encoded, decode from workers {np.nonzero(alive)[0].tolist()}",
                     sess, a, b, encoded=True, survivors=alive)
    require(torch.equal(y6, want), "t^2+z survivor decode != exact")

    walls = [drive(f"encoded, timed call {i}", sess, a, b, encoded=True)[1]
             for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    del y, y6, want

    h = torch.randn((1, D_MODEL), generator=gen, device=dev, dtype=torch.float64)
    w = 0.02 * torch.randn((D_MODEL, VOCAB), generator=gen, device=dev,
                           dtype=torch.float64)
    logits, float_wall, _ = drive("float h ~ N(0,1), W ~ N(0,0.02)", sess, h, w)
    ref = h @ w
    # fixed-point bound: |round(x 2^f)/2^f - x| <= 2^-(f+1) per operand, so
    # |err_j| <= 2^-(f+1) (sum_i |h_i| + sum_i |W_ij|) + K 2^-(2f+2)
    f = spec.field.frac_bits
    tol = (2.0 ** -(f + 1) * (h.abs().sum() + w.abs().sum(dim=0))
           + D_MODEL * 2.0 ** -(2 * f + 2))
    err = (logits - ref).abs()[0]
    require(logits.shape == (1, VOCAB) and bool(torch.isfinite(logits).all()),
            "float logits malformed")
    require(bool((err <= tol).all()), f"float error {float(err.max())} beyond "
            f"the fixed-point bound")
    print(f"  float: max |err| {float(err.max()):.3e}, bound "
          f"{float(tol.min()):.3e}..{float(tol.max()):.3e}; greedy token "
          f"{int(logits.argmax())} vs plaintext {int(ref.argmax())}", flush=True)
    del h, w, logits, ref

    m31 = connect(MPCSpec(s=2, t=2, z=2, field=Field(P_MERSENNE31)))
    a31, b31 = rand(P_MERSENNE31, 1, D_MODEL), rand(P_MERSENNE31, D_MODEL, VOCAB)
    y31, _, _ = drive("encoded, Mersenne-31 field", m31, a31, b31, encoded=True)
    require(torch.equal(y31, modmatmul_plain(a31, b31, p=P_MERSENNE31)),
            "M31 main path != exact")
    del a31, b31, y31

    print(f"main path per call: {[round(x * 1e3, 1) for x in walls]} ms wall "
          f"(encoded), {float_wall * 1e3:.1f} ms (float); peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)", flush=True)
    kern_ms = MAIN_BLOCKS * (rec[("modmatmul_batched", p)]["ms"]
                             + rec[("polyeval", p)]["ms"])
    print(f"  kernel time per call ({MAIN_BLOCKS} x (modmatmul_batched + 5 "
          f"polyeval), from the checks above): {kern_ms:.1f} ms = "
          f"{100 * kern_ms / (1e3 * min(walls)):.1f}% of the fastest call",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sess.matmul(a, b, encoded=True)
        torch.cuda.synchronize()
    # device-side rows only (kernels and copies): the operator rows above
    # them carry the same time again
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"device time of one encoded main-path call (torch.profiler): "
          f"{busy / 1e3:.3f} ms in {sum(r[1] for r in rows)} device events")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f} %  "
              f"x{count:<4d} {key[:100]}")

    # ------------------------------------- the tags stage (modmatmul, W=1)
    # the per-share MAC tags of one main-path block, on the same plan
    plan = spec.plan(m)
    i_pts = rand(p, spec.n_workers, blk, blk)
    rvec = rand(p, col)
    offsets = rand(p, spec.n_workers)
    reset_launch_counts()
    tags = plan.stages(dev).tags(i_pts, 12345, offsets, rvec)
    torch.cuda.synchronize()
    tags_counts = launch_counts()
    require(tags_counts == {"modmatmul_batched": 0, "modmatmul": 1,
                            "polyeval": 0}, f"tags stage launch counts {tags_counts}")
    tags_want = (12345 * modmatmul_plain(i_pts.reshape(spec.n_workers, col),
                                         rvec.reshape(col, 1), p=p)[:, 0]
                 + offsets) % p
    require(torch.equal(tags, tags_want), "tags stage != plain")
    print(f"tags stage on the main path's plan: equal to plain, launches "
          f"{tags_counts}", flush=True)

    # ------------------------------------------------------------ report

    meta = {
        "modmatmul_batched": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                              "src/repro/kernels/modmatmul.py:64",
                              main_counts["modmatmul_batched"],
                              f"[17,{blk},{blk}] @ [17,{blk},{blk}]"),
        "polyeval": ("src/repro_torch/kernels/csrc/polyeval.cu",
                     "src/repro/kernels/polyeval.py:33",
                     main_counts["polyeval"],
                     "one block's 5 launches: [17,6],[17,6],[17,17],[17,2],"
                     f"[4,6] @ [K,{col}]"),
        "modmatmul": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                      "src/repro/kernels/modmatmul.py:42",
                      tags_counts["modmatmul"],
                      f"tags stage: [17,{col}] @ [{col},1]"),
    }
    kernels = []
    for name, (source, replaces, launches, shape) in meta.items():
        r = rec[(name, p)]
        bms, by = bound(*r["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shape": shape, "p": p,
            "path": "tags stage" if name == "modmatmul" else "main path",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

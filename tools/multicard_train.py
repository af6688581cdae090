"""The multi-rank trainer against one rank with microbatches, and the
harness that ``chip_smoke.py`` and the tests share.

    python3 tools/multicard_train.py [--nproc 4] [--layers 16] [--steps 7]
    PYTHONPATH=src python tools/multicard_train.py --device cpu --reduced \\
        --seq 32      # a rehearsal: gloo ranks on the CPU

Four legs on one repeated batch of ``2 · nproc`` rows (llama3.2-1b at
full width, ``--layers`` deep, bf16, fp32 AdamW; ``--reduced``: the
reduced fp32 config):

1. one rank with ``microbatches = nproc`` on the whole batch (the first
   card), the reference;
2. ``nproc`` ranks, one a card over NCCL (gloo on the CPU), FSDP over
   ``data = nproc``: the losses and every weight against leg 1 (bit-equal
   leaves, the largest relative Frobenius difference), ms a step (steps
   1..2, no profiler), the collectives and, on cards, the NCCL kernels'
   device time, whole and by the ``fsdp.<kind>`` span that launched each
   (``torch.profiler`` and the program's spans on steps 4..,
   :data:`PROFILE_FROM`; step 0's set-up left out);
3. leg 2 with the clip norm taken from the slices (:func:`norm_from_slices`:
   one scalar all-reduce of the summed squares in place of the trainer's
   fp32 all-gather of every split gradient): what the trainer's bit
   equality costs a step, and how far from leg 1 the cheaper norm lands;
4. ``pod = 2, data = nproc / 2`` with ``compress_pod``: :class:`FeedbackCheck`
   on the trainer's own reductions at every step, the residuals in the
   step's state, and the losses, which must fall.

Prints the card's name and power limit, then one JSON line; exits 1 when
leg 2 misses 1e-6 relative or leg 4 a guarantee (leg 3 is measured, not
held to a bound).

The harness: :class:`Repeated` (one batch at every step), :func:`spawn`
(the ranks of one job, rank 0's result back), :func:`one_rank` (the
reference), :func:`compare` and :class:`FeedbackCheck`.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 1e-6

#: what a job of :func:`spawn` does unless it says otherwise
JOB = {"backend": None, "seed": 0, "repeat": True, "compress": False,
       "norm": "gathered", "profile": False}
#: a profiled job's steps: 0 sets up, 1..PROFILE_FROM - 2 are timed
#: without the profiler, PROFILE_FROM - 1 warms it up, and it traces
#: PROFILE_FROM.. to the end
PROFILE_FROM = 4


class Repeated:
    """Step 0's batch of a stream (an object with ``batch_np(step)``, such
    as :class:`~repro_torch.data.pipeline.SyntheticTokens`) at every step,
    rows lo:hi, so that the loss must fall."""

    def __init__(self, stream):
        self.host = stream.batch_np(0)

    def batch_np(self, step, lo=0, hi=None):
        return {k: v[lo:hi] for k, v in self.host.items()}


def _repeated(cfg, seq, batch, seed) -> Repeated:
    from repro_torch.data.pipeline import SyntheticTokens

    return Repeated(SyntheticTokens(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))


class FeedbackCheck:
    """``compressed_psum``'s guarantees, read from the trainer's own
    reductions (``train_loop(probe=...)``, or ``compressed_psum``'s
    ``stages``) at every call, with this check's own arithmetic and
    collectives over ``group`` (the ``pod`` ranks; None: every rank):

    * fed back: each leaf's incoming residual is the one the step before
      left (zeros at the first), and ``g32 = g + e`` in fp32;
    * the scale is the shared absmax (an ``all_reduce(MAX)`` here) plus
      1e-12, over 127, within ``2^-22`` of that in fp64 (three fp32
      roundings at most);
    * ``q`` is ``g32 / scale`` rounded half to even and clipped to ±127;
    * the residual is ``g32 - q·scale`` rounded once to fp32 (the product
      and the difference are exact in fp64), bit for bit;
    * every reduced element lies within ``scale / 2`` of the exact mean
      of the ``g32`` (an fp32 ``all_reduce(SUM)`` here), up to the mean's
      own rounding, ``2^-22`` of ``|mean| + scale``.

    :meth:`report` adds that the step's state holds the last residuals."""

    def __init__(self, group):
        self.pg = group                 # the ranks of the reduction
        self.n = dist.get_world_size(group)
        self.prev = None
        self.steps = 0
        self.held = dict.fromkeys(("fed_back", "scale", "q_exact",
                                   "residual_exact", "within_half_scale"),
                                  True)
        self.worst = 0.0

    def __call__(self, stages):
        ok = self.held
        for name, s in stages.items():
            e = s["e"]
            want = (torch.zeros_like(s["g32"]) if self.prev is None
                    else self.prev[name])
            ok["fed_back"] &= e is not None and torch.equal(e, want)
            g32 = s["g"].to(torch.float32) + want
            ok["fed_back"] &= torch.equal(g32, s["g32"])
            absmax = torch.max(torch.abs(g32))
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=self.pg)
            scale = float(s["scale"])
            exact = (float(absmax) + 1e-12) / 127
            ok["scale"] &= abs(scale - exact) <= 2.0 ** -22 * exact
            q = torch.clamp(torch.round(g32 / s["scale"]), -127, 127)
            ok["q_exact"] &= torch.equal(q.to(torch.int8), s["q"])
            resid = g32.double() - s["q"].double() * scale
            ok["residual_exact"] &= torch.equal(resid.float(), s["error"])
            mean = g32.clone()
            dist.all_reduce(mean, group=self.pg)
            mean = mean / self.n
            gap = torch.abs(s["out"].to(torch.float32) - mean)
            slack = 2.0 ** -22 * (torch.abs(mean) + scale)
            ok["within_half_scale"] &= bool(
                torch.all(gap <= scale / 2 + slack))
            self.worst = max(self.worst, float(torch.max(gap)) / (scale / 2))
        self.prev = {name: s["error"] for name, s in stages.items()}
        self.steps += 1

    def report(self, feedback) -> dict:
        """Every guarantee over the steps seen, the worst ``|out - mean| /
        (scale / 2)``, and whether ``feedback`` (the state's residuals
        after the last step) holds the last step's residuals."""
        state = self.prev is not None and all(
            torch.equal(feedback[n], e) for n, e in self.prev.items())
        rep = {k: bool(v) for k, v in self.held.items()}
        rep.update(steps=self.steps, state_holds_residuals=state,
                   worst_over_half_scale=self.worst)
        rep["ok"] = all(self.held.values()) and state and self.steps > 1
        return rep


def norm_from_slices(layout, names, grads):
    """The clip norm as each rank can take it from what it holds: the
    squares of its slices of the split leaves summed and all-reduced over
    ``data`` (one scalar), plus the replicated leaves' squares.  It rounds
    in another order than one rank's norm of whole gradients, so it is
    not that rank's to the bit (leg 3 measures how far)."""
    if not layout.dims:
        return None
    dev = grads[0].device
    split = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    for name, g in zip(names, grads, strict=True):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        if name in layout.dims:
            split = split + sq
        else:
            whole = whole + sq
    dist.all_reduce(split, group=layout.data_group)
    return torch.sqrt(split + whole)


def nccl_by_span(kernels, launch, records, offset) -> dict:
    """NCCL device ms by the ``fsdp.<kind>`` span open on the host when
    each kernel was launched.  ``kernels``: ``(correlation id, device
    ns)``; ``launch``: the profile time (Unix-epoch ns) of the runtime
    call of each correlation id; ``records``: the program's spans
    (``perf_counter_ns``), of which the ``fsdp.`` ones are read;
    ``offset``: ``time_ns - perf_counter_ns``.  ``""`` holds the kernels
    launched outside every such span or with no runtime call."""
    ivs = sorted((r.start_ns, r.end_ns, r.name) for r in records
                 if r.name.startswith("fsdp."))
    starts = [iv[0] for iv in ivs]
    out: collections.Counter = collections.Counter()
    for corr, ns in kernels:
        name = ""
        if corr in launch:
            t = launch[corr] - offset
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                name = ivs[i][2]
        out[name] += ns / 1e6
    return dict(out)


def _device_ms(prof, records, offset):
    """``(nccl, busy, by_span)``: device ms of the profiled kernels whose
    name holds ``nccl``, of every device operation, and the first by
    :func:`nccl_by_span` (each kernel's runtime call, ``cu*``, found by
    its correlation id).  The profiler's annotations are left out: each
    NCCL call's range shows on the device too, under the kernel's name."""
    kernels, launch, busy = [], {}, 0
    for e in prof.profiler.kineto_results.events():
        corr = int(e.correlation_id())
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation():
                continue
            busy += int(e.duration_ns())
            if "nccl" in e.name().lower():
                kernels.append((corr, int(e.duration_ns())))
        elif corr and e.name().startswith("cu"):
            launch.setdefault(corr, int(e.start_ns()))
    return (sum(ns for _, ns in kernels) / 1e6, busy / 1e6,
            nccl_by_span(kernels, launch, records, offset))


class _Stepping(list):
    """``train_loop``'s ``history`` that moves the profiler's schedule on
    as each step ends."""

    def __init__(self, prof):
        super().__init__()
        self.prof = prof

    def append(self, item):
        super().append(item)
        self.prof.step()


def _rank(rank, world, init, job, out_path):
    """One rank of :func:`spawn`'s job: join the group, train, gather the
    weights; rank 0 saves what the parent reads."""
    from repro_torch import spans
    from repro_torch.launch.mesh import process_mesh
    from repro_torch.launch.train import init_ranks, train_loop
    from repro_torch.parallel import fsdp

    if job["device"] == "cpu":
        torch.set_num_threads(1)        # the ranks share the cores
    dev = init_ranks(rank, world, device=job["device"],
                     backend=job["backend"], init_method=init)
    try:
        torch.backends.cuda.matmul.allow_tf32 = job["tf32"]
        cfg, tc = job["cfg"], job["tc"]
        mesh = process_mesh(job["shape"], job["axes"], device=dev.type)
        data = (_repeated(cfg, job["seq"], job["batch"], job["seed"])
                if job["repeat"] else None)
        check = (FeedbackCheck(mesh.get_group("pod")) if job["compress"]
                 else None)
        if job["norm"] == "slices":
            fsdp.Layout.global_norm = norm_from_slices
        traced: dict = {}
        prof = contextlib.nullcontext()
        history: list = []
        if job["profile"]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # the profile's clock is Unix-epoch ns, the spans' perf_counter
            offset = time.time_ns() - time.perf_counter_ns()

            def ready(p):
                traced.update(zip(
                    ("nccl_device_ms", "busy_device_ms", "nccl_ms_by_span"),
                    _device_ms(p, spans.take().records, offset), strict=True))

            prof = torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=PROFILE_FROM - 1, warmup=1,
                    active=job["steps"] - PROFILE_FROM, repeat=1),
                on_trace_ready=ready)
            history = _Stepping(prof)
            spans.enable()
        fsdp.reset_stats()
        with prof:
            params, opt_state, losses = train_loop(
                cfg, tc, steps=job["steps"], global_batch=job["batch"],
                seq_len=job["seq"], ckpt_dir=None, log_every=100,
                seed=job["seed"], device=dev, data=data, history=history,
                mesh=mesh, compress_pod=job["compress"], probe=check)
        spans.disable()
        layout = fsdp.Layout.for_config(cfg, mesh)
        out = {"backend": dist.get_backend(), "losses": losses,
               "history": list(history),
               "calls": dict(fsdp.STATS["calls"]),
               "split": sorted(layout.dims),
               "weights": {n: layout.gather(n, p.detach()).cpu()
                           for n, p in params.named_parameters()}}
        if dev.type == "cuda":
            out["peak"] = torch.cuda.max_memory_allocated(dev)
        out.update(traced)
        if check is not None:
            out["report"] = check.report(opt_state.feedback)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def spawn(**job) -> dict:
    """Run one job on ``prod(shape)`` spawned ranks and return rank 0's
    result: ``backend``, ``losses``, ``history`` (``train_loop``'s),
    ``calls`` (``fsdp.STATS``), ``split`` (the leaves split
    over ``data``), ``weights`` (whole, on the host), ``peak`` (bytes, on
    a card), ``nccl_device_ms``, ``busy_device_ms`` and
    ``nccl_ms_by_span`` (:func:`_device_ms`; with ``profile``: the
    traced steps', :data:`PROFILE_FROM` on), ``report``
    (:class:`FeedbackCheck`'s, with ``compress``) and ``wall_s``.

    The job: ``cfg``, ``tc``, ``shape``, ``axes``, ``device`` (ranks on
    ``cuda:<rank mod cards>`` or the CPU), ``steps``, ``batch``, ``seq``,
    and what :data:`JOB` defaults.  The ranks meet through a ``file://``
    rendezvous in a directory of their own (no fixed port)."""
    import torch.multiprocessing as mp

    job = {**JOB, **job, "tf32": torch.backends.cuda.matmul.allow_tf32}
    world = math.prod(job["shape"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.spawn(_rank, args=(world, init, job, path), nprocs=world)
        out = torch.load(path)
    out["wall_s"] = time.perf_counter() - t0
    return out


def one_rank(cfg, tc, *, device, steps, batch, seq, seed=0,
             repeat=True) -> dict:
    """The reference: one process on the whole batch (``tc`` gives its
    microbatches), on the CPU on one thread as each spawned rank runs
    (the CPU's reductions split their work by thread count).  Returns
    ``losses``, ``history``, ``s`` and ``weights`` (on the host)."""
    from repro_torch.launch.train import train_loop

    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    history: list = []
    t0 = time.perf_counter()
    try:
        params, _, losses = train_loop(
            cfg, tc, steps=steps, global_batch=batch, seq_len=seq,
            ckpt_dir=None, log_every=100, seed=seed, device=device,
            data=_repeated(cfg, seq, batch, seed) if repeat else None,
            history=history)
    finally:
        torch.set_num_threads(threads)
    return {"losses": losses, "history": history,
            "s": time.perf_counter() - t0,
            "weights": {n: p.detach().cpu()
                        for n, p in params.named_parameters()}}


def rel(a, b) -> float:
    """Relative Frobenius distance of two tensors (in fp64)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def compare(got, ref) -> dict:
    """How far a result (``losses``, ``weights``) lies from the
    reference's: the largest relative loss difference, the largest
    relative Frobenius difference of a weight with the three worst
    leaves, and the bit-equal leaves and losses."""
    diffs = {n: rel(got["weights"][n], w) for n, w in ref["weights"].items()}
    return {"loss_diff": max(abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref["losses"], strict=True)),
            "weight_diff": max(diffs.values()),
            "worst": sorted(diffs.items(), key=lambda x: -x[1])[:3],
            "bit_equal_leaves": sum(torch.equal(got["weights"][n], w)
                                    for n, w in ref["weights"].items()),
            "leaves": len(diffs),
            "losses_equal": list(got["losses"]) == list(ref["losses"])}


def steady_ms(history) -> float:
    """Mean ms a step over steps 1.. (step 0 sets up)."""
    steady = [h["s"] for h in history[1:]] or [history[0]["s"]]
    return 1e3 * sum(steady) / len(steady)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=7,
                    help=f"at least {PROFILE_FROM + 1}: steps "
                         f"{PROFILE_FROM}.. are traced")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.step import TrainConfig

    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            print(f"needs {args.nproc} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    cfg = get_config("llama3.2-1b")
    cfg = reduced(cfg) if args.reduced else dataclasses.replace(
        cfg, n_layers=args.layers)
    tc = TrainConfig(peak_lr=3e-4, warmup=0, stable=10_000, decay=1_000,
                     seq_chunk=min(512, args.seq))
    batch = 2 * args.nproc
    job = dict(cfg=cfg, tc=tc, device=args.device, steps=args.steps,
               batch=batch, seq=args.seq)
    ref = one_rank(cfg, dataclasses.replace(tc, microbatches=args.nproc),
                   device=torch.device(args.device, 0) if args.device == "cuda"
                   else "cpu", steps=args.steps, batch=batch, seq=args.seq)
    rec = {"nproc": args.nproc, "layers": cfg.n_layers,
           "tokens_per_step": batch * args.seq,
           "reference": {"losses": ref["losses"], "s": ref["s"],
                         "step_ms": [1e3 * h["s"] for h in ref["history"]]}}
    data_mesh = dict(shape=(args.nproc,), axes=("data",))
    traced = args.steps - PROFILE_FROM
    for leg, norm in (("fsdp", "gathered"), ("fsdp_norm_from_slices",
                                             "slices")):
        got = spawn(**job, **data_mesh, norm=norm, profile=True)
        hist = got["history"]
        ms = steady_ms(hist[:PROFILE_FROM - 1])
        rec[leg] = {
            "backend": got["backend"], "split_leaves": len(got["split"]),
            "losses": got["losses"], **compare(got, ref),
            "step_ms": ms, "tokens_per_s": batch * args.seq / (ms / 1e3),
            "traced_step_ms": 1e3 * sum(h["s"] for h in hist[PROFILE_FROM:])
            / traced,
            "nccl_device_ms_per_step": got.get("nccl_device_ms", 0) / traced,
            "nccl_ms_per_step_by_span": {
                k: v / traced
                for k, v in got.get("nccl_ms_by_span", {}).items()},
            "busy_device_ms_per_step": got.get("busy_device_ms", 0) / traced,
            "calls": got["calls"], "peak_gib": got.get("peak", 0) / 2**30,
            "wall_s": got["wall_s"]}
    c = spawn(**job, shape=(2, args.nproc // 2), axes=("pod", "data"),
              compress=True)
    rec["compress"] = {"backend": c["backend"], "report": c["report"],
                       "losses": c["losses"], "calls": c["calls"],
                       "step_ms": steady_ms(c["history"]),
                       "wall_s": c["wall_s"]}
    print(json.dumps({"multicard": rec}), flush=True)
    f = rec["fsdp"]
    ok = (f["loss_diff"] <= TOL and f["weight_diff"] <= TOL
          and c["report"]["ok"] and c["losses"][-1] < c["losses"][0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

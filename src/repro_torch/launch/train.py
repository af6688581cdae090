"""Training driver: end-to-end loop with seeded data, WSD schedule,
async checkpointing and exact-step restart.

Port of ``repro/launch/train.py`` (the card unless the caller passes
``device="cpu"``).  CPU-scale (reduced configs)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --device cpu --steps 5

At full width on the card (``--device cuda``, the default) every attention
runs the flash kernel forward and its hand-written backward, and so do
the WKV-6 recurrence (``rwkv6``, ``rwkv6_bwd``) and Mamba's selective scan
(``selective_scan``, ``selective_scan_bwd``): all six families train on
the card.

Several ranks (the reference's "same loop on a production mesh")::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --device cpu --steps 5 --nproc 4 --mesh pod=2,data=2

``--nproc N`` spawns N ranks (or, under ``torchrun``, reads its
environment), each on ``cuda:<rank>`` with NCCL (gloo with ``--device
cpu``), and drives :func:`train_loop` on the
process mesh ``--mesh`` (default ``data=N``): FSDP over ``data``, the
gradient mean over ``pod`` (``--compress-pod``: int8 with error
feedback), each rank on its rows of the global batch
(:mod:`repro_torch.parallel.fsdp`).  ``--nproc 1`` runs in this process.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, reduced
from ..data.pipeline import SyntheticTokens
from ..models.config import ModelConfig
from .mesh import process_mesh
from ..train.step import TrainConfig, init_train_state, make_train_step


def train_loop(cfg: ModelConfig, tc: TrainConfig, *, steps: int,
               global_batch: int, seq_len: int, ckpt_dir: Optional[str],
               ckpt_every: int = 20, log_every: int = 5, seed: int = 0,
               device="cuda", data=None, history: Optional[list] = None,
               mesh=None, compress_pod: bool = False,
               probe: Optional[Callable[[dict], None]] = None):
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    when there is one) and return ``(params, opt_state, losses)``, the
    losses of the steps this call ran.  ``data`` defaults to
    :class:`~repro_torch.data.pipeline.SyntheticTokens` from ``seed``; any
    object with ``batch_np(step)`` will do (``batch_np(step, lo=, hi=)``,
    this rank's rows, with ``mesh``).  With ``history``,
    each step appends ``{"step", "loss", "lr", "gnorm", "s"}`` (``s``: the
    step's wall time, which ends when its loss reaches the host).

    With ``mesh`` (:func:`~repro_torch.launch.mesh.process_mesh`) this
    rank trains on its rows of each global batch and holds its slices of
    the weights and moments (the returned ``params`` and ``opt_state``);
    the losses are the means over all ranks; rank 0 alone prints.
    ``probe``, with ``compress_pod``, is called with the stages of every
    step's compressed reduction (``Layout.probe``, for a check)."""
    device = torch.device(device)
    if data is None:
        data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=global_batch, seed=seed)
    step_fn = make_train_step(cfg, tc, mesh=mesh, compress_pod=compress_pod)
    layout = step_fn.layout
    if probe is not None:
        layout.probe = probe
    lo, hi = (0, global_batch) if layout is None else layout.rows(global_batch)
    talk = layout is None or layout.rank == 0
    mgr = CheckpointManager(ckpt_dir, layout=layout) if ckpt_dir else None

    params, opt_state = init_train_state(cfg, tc, seed, device=device,
                                         layout=layout)
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        if talk:
            print(f"[train] resumed from step {start}", flush=True)

    dtype = getattr(torch, cfg.dtype)
    rows = hi - lo
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        rows_np = (data.batch_np(step) if layout is None
                   else data.batch_np(step, lo=lo, hi=hi))
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                 for k, v in rows_np.items()}
        if cfg.family == "vlm":
            batch["embeds"] = torch.zeros(
                (rows, cfg.frontend_positions, cfg.d_model),
                dtype=dtype, device=device)
        if cfg.family == "encdec":
            batch["embeds"] = torch.zeros(
                (rows, seq_len, cfg.d_model), dtype=dtype, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": step, "loss": losses[-1],
                            "lr": float(metrics["lr"]),
                            "gnorm": float(metrics["gnorm"]),
                            "s": time.perf_counter() - t_step})
        if talk and (step % log_every == 0 or step == steps - 1):
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['gnorm']):.3f} ({dt:.1f}s)",
                  flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.wait()
        mgr.save(steps, {"params": params, "opt": opt_state})
    return params, opt_state, losses


def parse_mesh(text: Optional[str], nproc: int):
    """``"pod=2,data=2"`` as ``(shape, axes)``; None is ``data = nproc``."""
    if not text:
        return (nproc,), ("data",)
    axes, shape = [], []
    for part in text.split(","):
        name, _, size = part.partition("=")
        axes.append(name.strip())
        shape.append(int(size))
    return tuple(shape), tuple(axes)


def init_ranks(rank: int, world: int, *, device: str, backend: Optional[str],
               init_method: str) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` and return
    this rank's device: ``cuda:<rank mod cards>`` (two ranks share a card
    on a one-card machine, over gloo: NCCL refuses that), or the CPU."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def _rank_main(rank: int, world: int, args, init_method: str):
    """One rank of ``--nproc``: join the group, train, leave the group.
    Returns ``train_loop``'s result."""
    dev = init_ranks(rank, world, device=args.device, backend=None,
                     init_method=init_method)
    try:
        shape, axes = parse_mesh(args.mesh, world)
        mesh = process_mesh(shape, axes, device=dev.type)
        cfg, tc = _configs(args)
        out = train_loop(cfg, tc, steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                         device=dev, mesh=mesh, compress_pod=args.compress_pod)
        if rank == 0:
            losses = out[2]
            print(f"[train] {world} ranks, mesh "
                  f"{dict(zip(axes, shape, strict=True))}: first-loss "
                  f"{losses[0]:.4f} last-loss {losses[-1]:.4f}", flush=True)
        return out
    finally:
        dist.destroy_process_group()


def _configs(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(peak_lr=args.lr, warmup=max(2, args.steps // 10),
                     stable=args.steps, decay=max(2, args.steps // 10),
                     seq_chunk=min(512, args.seq))
    return cfg, tc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks to train on (0: one card, no process group)")
    ap.add_argument("--mesh", default=None,
                    help="axis sizes, e.g. pod=2,data=2 (default data=N)")
    ap.add_argument("--compress-pod", action="store_true",
                    help="int8 error-feedback gradient reduction over pod")
    args = ap.parse_args(argv)

    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:   # torchrun
        return _rank_main(int(os.environ["RANK"]),
                          int(os.environ["WORLD_SIZE"]), args, "env://")
    if args.nproc >= 1:
        with tempfile.TemporaryDirectory() as tmp:
            init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
            if args.nproc == 1:
                return _rank_main(0, 1, args, init_method)
            import torch.multiprocessing as mp

            mp.spawn(_rank_main, args=(args.nproc, args, init_method),
                     nprocs=args.nproc)
        return None
    cfg, tc = _configs(args)
    out = train_loop(cfg, tc, steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     device=args.device)
    losses = out[2]
    print(f"[train] first-loss {losses[0]:.4f} last-loss {losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()

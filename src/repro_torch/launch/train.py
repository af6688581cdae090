"""Training driver: end-to-end loop with seeded data, WSD schedule,
async checkpointing and exact-step restart.

Port of ``repro/launch/train.py`` for one card (the card unless the caller
passes ``device="cpu"``).  CPU-scale (reduced configs)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --device cpu --steps 5

At full width on the card (``--device cuda``, the default) every attention
runs the flash kernel forward and its hand-written backward, and so do
the WKV-6 recurrence (``rwkv6``, ``rwkv6_bwd``) and Mamba's selective scan
(``selective_scan``, ``selective_scan_bwd``): all six families train on
the card.  Multi-card meshes and the per-arch sharding packages are
ROADMAP queue 1, items 14 and 16.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, reduced
from ..data.pipeline import SyntheticTokens
from ..models.config import ModelConfig
from ..train.step import TrainConfig, init_train_state, make_train_step


def train_loop(cfg: ModelConfig, tc: TrainConfig, *, steps: int,
               global_batch: int, seq_len: int, ckpt_dir: Optional[str],
               ckpt_every: int = 20, log_every: int = 5, seed: int = 0,
               device="cuda", data=None, history: Optional[list] = None):
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    when there is one) and return ``(params, opt_state, losses)``, the
    losses of the steps this call ran.  ``data`` defaults to
    :class:`~repro_torch.data.pipeline.SyntheticTokens` from ``seed``; any
    object with ``batch_np(step)`` will do.  With ``history``, each step
    appends ``{"step", "loss", "lr", "gnorm", "s"}`` (``s``: the step's
    wall time, which ends when its loss reaches the host)."""
    device = torch.device(device)
    if data is None:
        data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=global_batch, seed=seed)
    step_fn = make_train_step(cfg, tc)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    params, opt_state = init_train_state(cfg, tc, seed, device=device)
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start}", flush=True)

    dtype = getattr(torch, cfg.dtype)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                 for k, v in data.batch_np(step).items()}
        if cfg.family == "vlm":
            batch["embeds"] = torch.zeros(
                (global_batch, cfg.frontend_positions, cfg.d_model),
                dtype=dtype, device=device)
        if cfg.family == "encdec":
            batch["embeds"] = torch.zeros(
                (global_batch, seq_len, cfg.d_model), dtype=dtype, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": step, "loss": losses[-1],
                            "lr": float(metrics["lr"]),
                            "gnorm": float(metrics["gnorm"]),
                            "s": time.perf_counter() - t_step})
        if step % log_every == 0 or step == steps - 1:
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(peak_lr=args.lr, warmup=max(2, args.steps // 10),
                     stable=args.steps, decay=max(2, args.steps // 10),
                     seq_chunk=min(512, args.seq))
    _, _, losses = train_loop(
        cfg, tc, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"[train] first-loss {losses[0]:.4f} last-loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()

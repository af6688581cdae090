"""Serving driver: batched prefill + greedy decode with the Engine.

Port of ``repro/launch/serve.py`` for one card (the card unless the caller
passes ``--device cpu``).  CPU-scale (reduced configs)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --reduced --batch 4 --prompt-len 32 --max-new 16 --device cpu

On the card (the default) every attention runs the flash kernel and every
WKV-6 recurrence and selective scan its kernel.  Weights come from the
port's ``init_params`` at seed 0 and the prompt from a second generator at
seed 1, as the reference draws them from ``PRNGKey(0)`` and
``PRNGKey(1)``; torch draws other numbers than JAX, so the tokens differ
from the reference's (the tests feed JAX's weights and prompt through
:func:`serve` instead).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import torch

from ..configs import get_config, reduced
from ..models.api import get_model
from ..models.config import ModelConfig
from ..mpc.errors import InvariantError
from ..mpc.field import resolve_device
from ..serve.engine import Engine

WEIGHT_SEED, PROMPT_SEED = 0, 1


def serve(cfg: ModelConfig, params, prompt, max_new: int, *,
          embeds: Optional[torch.Tensor] = None,
          device=None) -> Tuple[torch.Tensor, float]:
    """``(tokens, seconds)``: the greedy ``[B, max_new]`` continuation of
    ``prompt`` (``[B, T]`` ints) by ``Engine.generate`` on ``device`` (the
    card by default), and the seconds it took, the card drained."""
    engine = Engine(cfg, params, device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompt, max_new, embeds=embeds)
    if engine.device.type == "cuda":
        # analysis: allow(host-sync): the time ends when the card is done
        torch.cuda.synchronize(engine.device)
    return out, time.perf_counter() - t0


def inputs(cfg: ModelConfig, batch: int, prompt_len: int,
           device) -> Tuple[object, torch.Tensor, Optional[torch.Tensor]]:
    """``(params, prompt, embeds)`` as :func:`main` serves them: weights
    from ``init_params`` at :data:`WEIGHT_SEED`, a ``[batch, prompt_len]``
    prompt from a CPU generator at :data:`PROMPT_SEED` (the same tokens on
    any device), and the reference's fp32 zero stubs: ``[B,
    frontend_positions, d_model]`` for the vlm family, ``[B, prompt_len,
    d_model]`` frames for encdec."""
    dev = resolve_device(device)
    params = get_model(cfg).init_params(cfg, WEIGHT_SEED, device=dev)
    g = torch.Generator()
    g.manual_seed(PROMPT_SEED)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           dtype=torch.int64).to(dev)
    embeds = None
    if cfg.family == "vlm":
        embeds = torch.zeros((batch, cfg.frontend_positions, cfg.d_model),
                             dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        embeds = torch.zeros((batch, prompt_len, cfg.d_model),
                             dtype=torch.float32, device=dev)
    return params, prompt, embeds


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    params, prompt, embeds = inputs(cfg, args.batch, args.prompt_len, dev)
    out, dt = serve(cfg, params, prompt, args.max_new, embeds=embeds,
                    device=dev)
    toks = args.batch * args.max_new
    # analysis: allow(host-sync): the sample is printed from the host
    sample = out[0][:8].tolist()
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s); sample: {sample}")
    # analysis: allow(host-sync): the vocab check reads one scalar
    top = int(out.max().item()) if out.numel() else -1
    if top >= cfg.vocab:
        raise InvariantError(
            f"sampled token id {top} outside vocab {cfg.vocab}")
    return out


if __name__ == "__main__":
    main()

"""Hand-written CUDA kernels, with their plain twins.

* :mod:`.barrett` — ``mod_p``, ``matmul_limbs``, ``matmul_folded``: the
  plain torch ops (the CPU path and the kernels' oracle);
* :mod:`.modmatmul` — batched and single ``(A @ B) mod p``;
* :mod:`.polyeval` — skinny-K ``(V @ T) mod p`` share evaluation;
* :mod:`.flash_attention` — GQA softmax attention (the serve path's
  prefill, and training's forward) and its backward
  (``flash_attention_bwd``: dq, dk and dv, training's backward);
* :mod:`.rwkv6` — the RWKV-6 WKV recurrence with its final state (the
  rwkv family's prefill, and training's forward) and its backward
  (``rwkv6_bwd``: dr, dk, dv, dw, du and the start state's gradient);
* :mod:`.ring_fold` — ``(acc + chunk) mod p``, one hop of the sharded
  runner's int32 ring reduce-scatter (a port-only kernel);
* :mod:`.selective_scan` — Mamba's selective scan with its final state
  (the hybrid family's prefill, and training's forward; a port-only
  kernel) and its backward (``selective_scan_bwd``: du, ddt, da, db, dc);
* :mod:`._build` — ``nvcc`` build into ``build/kernels/`` and ``ctypes``
  binding, at first use;
* :mod:`.work` — what each kernel moves and computes; every wrapper's
  ``meta`` branch (shapes only, no launch, never the plain version)
  reports it to the dry-run's tally.

:func:`launch_counts` / :func:`reset_launch_counts` read and zero the
wrappers' launch counters, so a run can show which kernels it went through;
:func:`instance_counts` splits them by the instance each wrapper's chooser
picked (``modmatmul*``: ``tensor_core``, ``skinny`` or ``cuda_core``;
``flash_attention``: ``wgmma``, ``mma_sync`` or ``cuda_core``;
``flash_attention_bwd``: ``wgmma``, ``mma_sync`` or ``cuda_core``;
``rwkv6_bwd``: ``chunked`` or ``sweep``; ``selective_scan``: ``tma`` or
``simple``; ``selective_scan_bwd``: ``tma`` or ``sweep``).  The counters
also zero ``flash_attention.lse_launches``, the forward launches that
wrote the log-sum-exp for a backward (0 on the serve path).
"""
from __future__ import annotations

from typing import Dict

from . import flash_attention as _flash_attention
from . import modmatmul as _modmatmul
from . import polyeval as _polyeval
from . import ring_fold as _ring_fold
from . import rwkv6 as _rwkv6
from . import selective_scan as _selective_scan

WRAPPERS = {
    "modmatmul_batched": _modmatmul.modmatmul_batched,
    "modmatmul": _modmatmul.modmatmul,
    "polyeval": _polyeval.polyeval,
    "flash_attention": _flash_attention.flash_attention,
    "flash_attention_bwd": _flash_attention.flash_attention_bwd,
    "rwkv6": _rwkv6.rwkv6,
    "rwkv6_bwd": _rwkv6.rwkv6_bwd,
    "ring_fold": _ring_fold.ring_fold,
    "selective_scan": _selective_scan.selective_scan,
    "selective_scan_bwd": _selective_scan.selective_scan_bwd,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def instance_counts() -> Dict[str, Dict[str, int]]:
    """Launches per instance since the last reset, for the wrappers that
    choose between kernels."""
    return {name: dict(fn.instances) for name, fn in WRAPPERS.items()
            if hasattr(fn, "instances")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "instances"):
            fn.instances = dict.fromkeys(fn.instances, 0)
    _flash_attention.flash_attention.lse_launches = 0

"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
``build/kernels/lib<name>-<digest>.so`` under the checkout root (a
directory ``.gitignore`` lists).  The digest covers the source, the shared
header and the flags, so an edited kernel never loads a stale library.
Sources expose a plain C interface: pointers and the stream pass as
``c_void_p``, and every launcher returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing here runs at import: the CPU has no ``nvcc``, and the tests import
every module.  A build or load that fails raises; no caller falls back to
the plain ops.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from ..mpc.errors import InvariantError
from ..mpc.field import acc_window
from .barrett import barrett_params

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("modmatmul", "modmatmul_tc", "modmatmul_skinny", "polyeval",
           "flash_attention", "flash_attention_bwd", "rwkv6", "rwkv6_bwd",
           "ring_fold", "selective_scan", "selective_scan_bwd")
HEADERS = ("field.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled kernel library: where it is and what nvcc said."""

    name: str
    path: Path
    seconds: float    # 0.0 when an up-to-date library was already on disk
    log: str          # nvcc's output (``-Xptxas -v``: registers, smem, spills)


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                               "where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Build]:
    """Compile every named kernel whose library is missing, all at once.

    One ``nvcc`` process per source, started together and then awaited, so
    the wall time is that of the slowest source.  Raises
    :class:`KernelBuildError` with nvcc's output if any source fails.
    """
    names = tuple(names)
    unknown = sorted(set(names) - set(SOURCES))
    if unknown:
        raise KernelBuildError(f"unknown kernel sources {unknown}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Build] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = Build(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)      # atomic: a concurrent loader never sees
        out[name] = Build(name, path, secs, log)   # a half-written library
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name].path))
        return lib


def fold_args(p: int) -> tuple:
    """``(p, b, c, n_folds, window)`` as the kernels' launchers take them.

    Raises ``ValueError`` for a prime the kernels do not take: one that is
    not pseudo-Mersenne with at most 4 folds, or one whose elements do not
    fit the kernels' 32-bit operand registers.  The window is the one the
    overflow proof certifies (:func:`repro_torch.analysis.overflow.
    certified_window`); ``InvariantError`` if ``acc_window`` disagrees.
    """
    # lazy: the analysis package imports the field and the kernels' wrappers
    from ..analysis.overflow import certified_window

    params = barrett_params(p)
    if p >= 2**31 or params is None or params[2] > 4:
        raise ValueError(
            f"the mod-p kernels take pseudo-Mersenne primes p < 2^31 with at "
            f"most 4 folds; p={p} has fold parameters {params}")
    b, c, n_folds = params
    window = certified_window(p)
    if acc_window(p) != window:
        raise InvariantError(
            f"acc_window({p}) = {acc_window(p)} but the overflow proof "
            f"certifies {window}: the kernels' fold cadence has drifted")
    return p, b, c, n_folds, min(window, 2**30)


def count(fn, instance: str = None) -> None:
    """Add one launch to a wrapper's counter (and its instance's), under a
    lock: the remote backend's worker threads launch concurrently."""
    with _COUNT_LOCK:
        fn.launches += 1
        if instance is not None:
            fn.instances[instance] += 1


def check(err: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` for a nonzero ``cudaError_t``."""
    if err != 0:
        raise KernelLaunchError(f"{what} launch failed: cudaError_t {err}")

#!/usr/bin/env python3
"""Time the serve path's selective-scan forward of two source trees in one run.

    python3 tools/scan_serve_ab.py PARENT_CSRC [--rounds 3]

``PARENT_CSRC`` is the ``src/repro_torch/kernels/csrc`` directory of
another checkout (for example a ``git archive`` of the parent commit
unpacked under ``build/``).  Its ``selective_scan.cu`` is built with the
same ``nvcc`` flags into ``build/ab/`` and bound through its own C entry
point (the one without the checkpoint output), beside this tree's kernel
(``kernels._build``).  Both run the serve path's call (the ``tma``
instance, the final state, no checkpoints) on the same bf16 operands at
jamba-v0.1-52b's served prefills ``[1,2048]`` and ``[4,512]`` (Di 8192, N
16; u and b, c as the views the model hands over).  y and the state must
be equal bit for bit; each tree's device time is read from CUDA graphs of
20 calls, in the order parent, this tree, this tree, parent, ``--rounds``
times.  Prints the card's name and power limit first.  Needs a CUDA card
and ``nvcc``.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 2048), (4, 512))         # (B, T) at Di 8192, N 16
DI, N = 8192, 16


def graph_ms(torch, fn, iters=20):
    """Device time of one call from a CUDA graph of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_csrc")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_serve_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libselective_scan_parent.so")
    build = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
         os.path.join(args.parent_csrc, "selective_scan.cu")],
        capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    parent = ctypes.CDLL(lib_path).selective_scan_launch
    parent.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    parent.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for b, t in SHAPES:
        xz = torch.randn((b, t, 2 * DI), generator=gen, device=dev).bfloat16()
        bc = torch.randn((b, t, 2 * N), generator=gen, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, DI), generator=gen, device=dev) - 4).bfloat16()
        a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
            DI, N).contiguous()
        ops = (xz[..., :DI], dt, a, bc[..., :N], bc[..., N:])
        if ss.choose_instance(ops[0], ops[1], ops[3], ops[4]) != "tma":
            print("the serve operands do not take the tma instance",
                  file=sys.stderr)
            return 1
        y = torch.empty((b, t, DI), dtype=torch.float32, device=dev)
        h = torch.empty((b, DI, N), dtype=torch.float32, device=dev)
        strides = [st for x in (ops[0], ops[1], ops[3], ops[4])
                   for st in x.stride()[:2]]

        def run_parent():
            err = parent(ops[0].data_ptr(), ops[1].data_ptr(), a.data_ptr(),
                         ops[3].data_ptr(), ops[4].data_ptr(), y.data_ptr(),
                         h.data_ptr(), 1, 1, b, t, DI, N, *strides,
                         torch.cuda.current_stream().cuda_stream)
            _build.check(err, "parent selective_scan")
            return y, h

        def run_this():
            return ss._launch(*ops, instance="tma", return_state=True)

        py, ph = (x.clone() for x in run_parent())
        ty, th = run_this()
        same = torch.equal(py, ty) and torch.equal(ph, th)
        times = {"parent": [], "this": []}
        for _ in range(args.rounds):
            for who in ("parent", "this", "this", "parent"):
                times[who].append(graph_ms(
                    torch, run_parent if who == "parent" else run_this))
        print(f"[{b},{t},{DI},{N}] bf16, tma, final state, no checkpoints: y "
              f"and the state equal bit for bit: {same}; device ms per call "
              f"(CUDA graphs of 20): parent "
              f"{[round(x, 4) for x in times['parent']]}, this tree "
              f"{[round(x, 4) for x in times['this']]}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

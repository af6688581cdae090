#!/usr/bin/env python3
"""Time the serve path's flash forward of two source trees in one run.

    python3 tools/flash_serve_ab.py PARENT_CSRC [--rounds 3]

``PARENT_CSRC`` is the ``src/repro_torch/kernels/csrc`` directory of
another checkout (for example a ``git archive`` of the parent commit
unpacked under ``build/``).  Its ``flash_attention.cu`` is built with the
same ``nvcc`` flags into ``build/ab/`` and bound through its own C entry
point, beside this tree's kernel (``kernels._build``).  Both run the serve
path's call (no log-sum-exp output) on the same bf16 operands at
llama3.2-1b's prefill ``[1,2048,32/8,64]`` and olmoe-1b-7b's
``[1,2048,16,128]``, causal, the wgmma instance.  The outputs must be equal
bit for bit; each tree's device time is read from CUDA graphs of 20 calls,
in the order parent, this tree, this tree, parent, ``--rounds`` times.
Prints the card's name and power limit first.  Needs a CUDA card and
``nvcc``.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((32, 8, 64), (16, 16, 128))   # (Hq, Hkv, D) at B = 1, T = S = 2048


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
        print("flash_serve_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libflash_attention_parent.so")
    build = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
         os.path.join(args.parent_csrc, "flash_attention.cu")],
        capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    parent = ctypes.CDLL(lib_path).flash_attention_launch
    parent.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
    parent.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for hq, hkv, d in SHAPES:
        q = torch.randn((1, 2048, hq, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((1, 2048, hkv, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((1, 2048, hkv, d), generator=gen, device=dev).bfloat16()
        if fa.choose_instance(q, k, v) != "wgmma":
            print("the serve operands do not take the wgmma instance",
                  file=sys.stderr)
            return 1
        out = torch.empty_like(q)
        strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]

        def run_parent():
            err = parent(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         2, 1, 2048, 2048, hq, hkv, d, *strides, 1, 0,
                         float(d ** -0.5),
                         torch.cuda.current_stream().cuda_stream)
            _build.check(err, "parent flash_attention")
            return out

        def run_this():
            return fa._launch(q, k, v, instance="wgmma")

        same = torch.equal(run_parent().clone(), run_this())
        times = {"parent": [], "this": []}
        for _ in range(args.rounds):
            for who in ("parent", "this", "this", "parent"):
                times[who].append(graph_ms(
                    torch, run_parent if who == "parent" else run_this))
        print(f"[1,2048,{hq}/{hkv},{d}] causal bf16, wgmma, no lse: outputs "
              f"equal bit for bit: {same}; device ms per call (CUDA graphs of "
              f"20): parent {[round(x, 4) for x in times['parent']]}, this "
              f"tree {[round(x, 4) for x in times['this']]}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

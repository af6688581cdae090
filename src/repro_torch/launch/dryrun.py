"""Multi-pod dry-run: trace every (arch × shape) cell on the production mesh
on ``meta`` tensors and report, per H100, memory, FLOPs, HBM bytes and
collective bytes, with the roofline terms they give.

Port of ``repro/launch/dryrun.py``.  The reference forces 512 host
devices, then lowers and compiles each cell with ``jit(in_shardings=...)``.
The port has no compiler to ask.  It runs each cell once on ``meta``
tensors (shapes without storage), on ``make_production_mesh(devices=
["meta"] * n)``, under the cost tally of :mod:`.hlo_analysis` and
``torch.distributed._tools.mem_tracker.MemTracker``.  The reference's
first two lines (``XLA_FLAGS``) have no counterpart.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multipod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mpc   # protocol cell

How one device's numbers are made:

* **arguments**: each input leaf's block under its spec
  (:meth:`~repro_torch.parallel.sharding.NamedSharding.shard_shape`),
  summed: exact.
* **the traced program**: the cell at its per-device batch, that is, the
  global batch divided by the size of the mesh axes its ``batch`` spec
  uses, with whole weights.  Its tally is divided by ``model_split``,
  the ``model`` axis size when the cell splits the layers' work over it
  (tensor parallelism on the block weights, or sequence parallelism
  under :func:`~.specs.activation_rules`, or KV-sequence sharding in
  decode), else 1.  That split is the ideal one: a dim that does not
  divide is replicated in the reference's partition and divided here.
* **temporaries**: ``MemTracker``'s peak over the traced program less its
  arguments, with the weights, gradients and activations of the traced
  program (unsplit over ``model``).
* **outputs**: the traced outputs' bytes, any output that is an input
  (the trainer updates in place) at that input's block.
* **collectives** (closed form from the specs, bytes per device a step,
  counted as the reference counts a collective: its result, and a
  reduce-scatter's operand):

  - the port's trainer (:mod:`repro_torch.parallel.fsdp`), for a weight
    split over ``data`` (its block with ``data`` undone, W): an
    ``all-gather`` of W in its dtype once a step (gathered before the
    forward, held through the backward); an ``all-to-all`` of its fp32
    gradient's slices, ``pod`` · W · 4 bytes (each rank sends each rank
    of the mesh the slice that rank keeps, the other pods' replicas
    included); an fp32 ``all-gather`` of the summed slices, W · 4 bytes,
    for the clip norm;
  - for a weight not split over ``data`` (its block B): an fp32
    ``all-gather`` of every rank's gradient, ``pod`` · ``data`` · B · 4
    bytes (the trainer adds the ranks' parts in rank order, so the step
    equals one rank's with microbatches to the bit);
  - tensor parallelism (Megatron): two ``all-reduce`` s a layer of the
    activation ``[B_dev, T, D]`` in the model's dtype for the forward
    (after attention or the time mix, after the FFN), twice that for a
    train step (the backward's two), plus the forward again under remat;
  - sequence parallelism: an ``all-gather`` of K and V ``[B_dev, T, Hkv,
    hd]`` an attention layer, and for a train step a ``reduce-scatter``
    of their gradients;
  - expert parallelism: two ``all-to-all`` s a MoE layer (dispatch and
    combine) of ``[B_dev · T · top_k, D]``, doubled for a train step.

  The vocab-parallel head's ``[B, T]`` reductions are left out.
* **roofline** (NVIDIA H100 SXM data sheet): ``compute_s = flops /
  989e12`` (bf16 dense), ``memory_s = hbm_bytes / 3.35e12``,
  ``nvlink_s = collective bytes / 450e9`` (NVLink 4, one direction) and
  ``ib_s = collective bytes / 50e9`` (one 400 Gb/s NDR port a GPU, the
  links between nodes), and whether the arguments and temporaries fit
  80 GB.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from ..configs import ARCHS, applicable_shapes, get_config, reduced
from ..kernels.work import BF16_OPS_PER_S, HBM_BYTES, HBM_BYTES_PER_S
from ..models.config import SHAPE_BY_NAME, ModelConfig, ShapeConfig
from ..parallel.sharding import (
    NamedSharding,
    mesh_shape,
    sharding_ctx,
    spec_for,
)
from .hlo_analysis import Tally
from .mesh import make_production_mesh
from .specs import build_cell, tensor_leaves

NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9


def _axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else entry


def _split(sizes: dict, spec, axis: str) -> int:
    """How many ways ``spec`` splits a leaf over ``axis``."""
    return sizes[axis] if any(axis in _axes(e) for e in spec) else 1


def _block_bytes(t: torch.Tensor, sharding) -> int:
    return math.prod(sharding.shard_shape(t.shape)) * t.element_size()


def argument_bytes(args, shardings) -> int:
    """Per-device bytes of a cell's inputs: each leaf's block."""
    total = 0
    for a, s in zip(args, shardings, strict=True):
        leaves, shards = _leaves_with(a, s)
        total += sum(_block_bytes(t, sh) for t, sh in zip(leaves, shards,
                                                           strict=True))
    return total


def _leaves_with(arg, shard):
    """The tensor leaves of one argument with their shardings."""
    if isinstance(arg, torch.Tensor):
        return [arg], [shard]
    if isinstance(arg, torch.nn.Module):
        named = dict(arg.named_parameters())
        return list(named.values()), [shard[n] for n in named]
    if isinstance(arg, dict):
        out_t, out_s = [], []
        for k, v in arg.items():
            t, s = _leaves_with(v, shard[k])
            out_t += t
            out_s += s
        return out_t, out_s
    if isinstance(arg, tuple) and hasattr(arg, "_fields"):     # AdamWState
        out_t, out_s = [], []
        for v, s in zip(arg, shard, strict=True):
            t, ss = _leaves_with(v, s)
            out_t += t
            out_s += ss
        return out_t, out_s
    if isinstance(arg, int):
        return [], []
    return tensor_leaves(arg), _sharding_leaves(shard)   # a cache


def _sharding_leaves(tree) -> list:
    """The ``NamedSharding`` leaves of :func:`~.specs.cache_shardings`'
    tree, in :func:`~.specs.tensor_leaves`' order."""
    if isinstance(tree, NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [y for v in tree.values() for y in _sharding_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [y for v in tree for y in _sharding_leaves(v)]
    return []


def _bytes(x) -> int:
    return x.numel() * x.element_size()


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, cell, mesh,
                     rows: int) -> dict:
    """The cell's collectives in closed form (module docstring): bytes and
    counts per kind, per device, one step."""
    sizes = mesh_shape(mesh)
    kind = cell.meta["kind"]
    rules = cell.meta.get("rules") or {}
    params, p_shard = cell.args[0], cell.in_shardings[0]
    totals: dict = {}
    counts: dict = {}

    def add(op, nbytes, n=1):
        if nbytes > 0 and n > 0:
            totals[op] = totals.get(op, 0) + int(nbytes)
            counts[op] = counts.get(op, 0) + int(n)

    data = sizes.get("data", 1)
    pod = sizes.get("pod", 1)
    mp = sizes.get("model", 1)
    dtype_bytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    tp_on = False
    for name, p in params.named_parameters():
        spec = p_shard[name].spec
        block = math.prod(p_shard[name].shard_shape(p.shape))
        by_data = _split(sizes, spec, "data")
        if _split(sizes, spec, "model") > 1 and not (
                "embed" in name or "lm_head" in name):
            tp_on = True
        if by_data > 1:
            whole = block * by_data
            add("all-gather", whole * p.element_size())
            if kind == "train":
                add("all-to-all", pod * whole * 4)
                add("all-gather", whole * 4)        # the clip norm's
        elif kind == "train" and data * pod > 1:
            add("all-gather", data * pod * block * 4)
    t = 1 if kind == "decode" else shape.seq_len
    act = rows * t * cfg.d_model * dtype_bytes
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    if tp_on and mp > 1:
        per_layer = 2 if kind != "train" else (6 if cfg.remat else 4)
        add("all-reduce", act * per_layer * layers, per_layer * layers)
    if rules.get("seq") == "model" and mp > 1 and cfg.n_heads:
        kv = rows * t * cfg.n_kv_heads * cfg.resolved_head_dim * dtype_bytes
        attn_layers = _attention_layers(cfg)
        add("all-gather", 2 * kv * attn_layers, 2 * attn_layers)
        if kind == "train":
            add("reduce-scatter", 2 * kv * attn_layers, 2 * attn_layers)
    if cfg.moe is not None and mp > 1 and cfg.moe.n_experts % mp == 0:
        moe_layers = _moe_layers(cfg)
        n = 2 * moe_layers * (2 if kind == "train" else 1)
        add("all-to-all", rows * t * cfg.moe.top_k * cfg.d_model
            * dtype_bytes * n, n)
    return {"bytes": totals, "counts": counts,
            "total_bytes": int(sum(totals.values())), "tensor_parallel": tp_on}


def _attention_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return sum(1 for l in range(cfg.n_layers)
                   if cfg.attn_every and l % cfg.attn_every == cfg.attn_offset)
    if cfg.family == "encdec":
        return cfg.n_layers * 2 + cfg.n_enc_layers
    return cfg.n_layers if cfg.n_heads else 0


def _moe_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return sum(1 for l in range(cfg.n_layers) if l % 2 == 1)
    return cfg.n_layers


def _batch_split(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """How many ways the cell's batch splits (its ``batch`` spec)."""
    sizes = mesh_shape(mesh)
    spec = spec_for((shape.global_batch, shape.seq_len), ("batch", None), mesh)
    return math.prod(sizes[a] for a in _axes(spec[0]))


def _model_split(cfg, cell, mesh, tp_on: bool) -> int:
    rules = cell.meta.get("rules") or {}
    mp = mesh_shape(mesh).get("model", 1)
    if tp_on or rules.get("seq") == "model" or rules.get("seq_kv") == "model":
        return mp
    return 1


def _output_bytes(out, args, shardings) -> int:
    """Bytes of the outputs, an output that is an input at its block."""
    blocks = {}
    for a, s in zip(args, shardings, strict=True):
        leaves, shards = _leaves_with(a, s)
        for t, sh in zip(leaves, shards, strict=True):
            blocks[id(t)] = _block_bytes(t, sh)
    total = 0
    for x in _flat_outputs(out):
        total += blocks.get(id(x), _bytes(x))
    return total


def _flat_outputs(out) -> list:
    if isinstance(out, torch.nn.Module):
        return list(out.parameters())
    if isinstance(out, (list, tuple)) and not hasattr(out, "_fields"):
        return [y for x in out for y in _flat_outputs(x)]
    if isinstance(out, dict):
        return [y for x in out.values() for y in _flat_outputs(x)]
    return tensor_leaves(out)


def trace_cell(cell):
    """Run ``cell.fn(*cell.args)`` once under the tally and ``MemTracker``:
    ``(tally summary, peak bytes, arguments' traced bytes, outputs)``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    arg_leaves = []
    for a in cell.args:
        if isinstance(a, torch.nn.Module):
            arg_leaves += list(a.parameters())
        elif isinstance(a, dict):
            arg_leaves += [y for v in a.values() for y in tensor_leaves(v)]
        else:
            arg_leaves += tensor_leaves(a)
    traced_args = sum(_bytes(x) for x in arg_leaves)
    mt = MemTracker()
    mt.track_external(*[a for a in cell.args if isinstance(a, torch.nn.Module)])
    with mt, Tally() as tally:
        out = cell.fn(*cell.args)
    peak = mt.get_tracker_snapshot("peak")
    peak_total = max(v["Total"] for v in peak.values()) if peak else 0
    return tally.summary(), peak_total, traced_args, out


def roofline(flops: float, hbm: float, coll: float, resident: float) -> dict:
    return {"compute_s": flops / BF16_OPS_PER_S,
            "memory_s": hbm / HBM_BYTES_PER_S,
            "nvlink_s": coll / NVLINK_BYTES_PER_S,
            "ib_s": coll / IB_BYTES_PER_S,
            "hbm_capacity_bytes": HBM_BYTES,
            "fits_hbm": bool(resident <= HBM_BYTES)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str], overrides: Optional[dict] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, mesh=None) -> dict:
    """Trace one cell and write ``<arch>__<shape>__<tag>.json`` under
    ``out_dir`` (None writes nothing).  ``cfg``, ``shape`` and ``mesh``
    replace the registry's and the production mesh (tests)."""
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPE_BY_NAME[shape_name]
    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    split = _batch_split(cfg, shape, mesh)
    rows = shape.global_batch // split
    local = dataclasses.replace(shape, global_batch=rows)
    traced = build_cell(cfg, local, mesh) if split > 1 else cell
    with sharding_ctx(mesh, cell.meta.get("rules")):
        h, peak, traced_args, out = trace_cell(traced)
    t_trace = time.time() - t0
    coll = collective_bytes(cfg, shape, cell, mesh, rows)
    ms = _model_split(cfg, cell, mesh, coll["tensor_parallel"])
    per_dev = dict(h)
    for key in ("flops", "hbm_bytes", "hbm_bytes_fused", "hbm_bytes_unfused",
                "kernel_flops"):
        per_dev[key] = h[key] / ms
    per_dev["collective_bytes"] = coll["bytes"]
    per_dev["collective_counts"] = coll["counts"]
    per_dev["collective_total_bytes"] = coll["total_bytes"]
    args_b = argument_bytes(cell.args, cell.in_shardings)
    temp = max(0, peak - traced_args)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_shape(mesh),
        "n_devices": int(math.prod(mesh_shape(mesh).values())),
        "kind": cell.meta.get("kind"),
        "trace_s": round(t_trace, 2),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "tokens": shape.global_batch * (1 if shape.kind == "decode"
                                        else shape.seq_len),
        "rows_per_device": rows,
        "model_split": ms,
        "memory": {"argument_size_in_bytes": args_b,
                   "output_size_in_bytes": _output_bytes(
                       out, traced.args, traced.in_shardings),
                   "temp_size_in_bytes": temp},
        "collectives": {k: coll[k] for k in ("bytes", "counts", "total_bytes")},
        "hlo_analysis": per_dev,
        "traced": h,
    }
    result["roofline"] = roofline(per_dev["flops"], per_dev["hbm_bytes"],
                                  coll["total_bytes"], args_b + temp)
    tag = "multipod" if multi_pod else "singlepod"
    path = _write(out_dir, f"{arch}__{shape.name}__{tag}.json", result)
    r = result["roofline"]
    print(f"[dryrun] {arch} × {shape.name} ({tag}): trace {result['trace_s']}s, "
          f"args/dev {args_b / 1e9:.3f} GB, temp/dev {temp / 1e9:.3f} GB "
          f"of {HBM_BYTES / 1e9:.0f} GB, flops/dev {per_dev['flops']:.3e}, "
          f"coll/dev {coll['total_bytes']:.3e} B; compute {r['compute_s']:.4f}s "
          f"memory {r['memory_s']:.4f}s nvlink {r['nvlink_s']:.4f}s "
          f"ib {r['ib_s']:.4f}s" + (f" -> {path}" if path else ""), flush=True)
    return result


def _write(out_dir: Optional[str], name: str, result: dict) -> Optional[str]:
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def run_mpc_cell(*, multi_pod: bool, out_dir: Optional[str],
                 s: int = 4, t: int = 9, z: int = 42, m: int = 36000,
                 scheme: str = "age", wire_dtype: str = "int64",
                 prg_masks: bool = False, variant: str = "",
                 mesh=None) -> dict:
    """Trace the CMPC protocol step itself on the production mesh (workers
    on the 'model' axis) — the paper's own workload at Fig. 2/3 scale:
    m=36000, st=36, z=42 — through the mod-p kernels' meta branches.  The
    sharded runner drives every shard of the axis from one process, so
    one device's numbers are the tally over the axis divided by its
    size.  Collectives: the I-points' reduce-scatter, each shard's
    ``[N_pad, (m/t)^2]`` payload in the wire's type."""
    from ..mpc.protocol import AGECMPCProtocol
    from ..mpc.secure_matmul import WIRE_DTYPES, ShardedCMPC

    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    proto = AGECMPCProtocol(s=s, t=t, z=z, m=m, scheme=scheme)
    sh = ShardedCMPC(proto, mesh, "model", wire_dtype=wire_dtype,
                     prg_masks=prg_masks)
    t0 = time.time()
    step = sh.build_step()
    ts_z = proto.t * proto.s + proto.z
    dt = WIRE_DTYPES[wire_dtype]
    meta = {"device": "meta"}
    masks = (list(range(sh.n_pad)) if prg_masks else
             torch.empty((sh.n_pad, z, m // t, m // t), dtype=dt, **meta))
    args = (torch.empty((ts_z, m // t, m // s), dtype=dt, **meta),
            torch.empty((ts_z, m // s, m // t), dtype=dt, **meta), masks)
    with Tally() as tally:
        step(*args)
    h = tally.summary()
    d = sh.axis_size
    per_dev = dict(h)
    for key in ("flops", "hbm_bytes", "hbm_bytes_fused", "hbm_bytes_unfused",
                "kernel_flops"):
        per_dev[key] = h[key] / d
    wire_bytes = torch.empty((), dtype=dt).element_size()
    coll = {"reduce-scatter": sh.n_pad * (m // t) ** 2 * wire_bytes}
    per_dev["collective_bytes"] = coll
    per_dev["collective_counts"] = {"reduce-scatter": 1}
    per_dev["collective_total_bytes"] = int(sum(coll.values()))
    arg_b = sum(x.numel() * x.element_size() for x in args[:2])
    if not prg_masks:
        arg_b += masks.numel() * masks.element_size() // d
    result = {
        "arch": f"{scheme}-cmpc(s={s},t={t},z={z},m={m})",
        "shape": "protocol_step",
        "mesh": mesh_shape(mesh),
        "n_workers": proto.n_workers,
        "variant": variant or "baseline",
        "trace_s": round(time.time() - t0, 2),
        "memory": {"argument_size_in_bytes": arg_b},
        "collectives": {"bytes": coll, "counts": {"reduce-scatter": 1},
                        "total_bytes": per_dev["collective_total_bytes"]},
        "hlo_analysis": per_dev,
        "traced": h,
    }
    result["roofline"] = roofline(per_dev["flops"], per_dev["hbm_bytes"],
                                  per_dev["collective_total_bytes"], arg_b)
    tag = "multipod" if multi_pod else "singlepod"
    vtag = f"__{variant}" if variant else ""
    path = _write(out_dir, f"{scheme}-cmpc__protocol{vtag}__{tag}.json", result)
    r = result["roofline"]
    print(f"[dryrun] MPC {scheme}{vtag} ({tag}): N={proto.n_workers}, "
          f"trace {result['trace_s']}s, kernels {h['kernel_calls']}, "
          f"comp={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s "
          f"nvlink={r['nvlink_s']:.3f}s" + (f" -> {path}" if path else ""),
          flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mpc", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--m", type=int, default=36000,
                    help="--mpc: block side m (default the paper's 36000)")
    ap.add_argument("--s", type=int, default=4)
    ap.add_argument("--t", type=int, default=9)
    ap.add_argument("--z", type=int, default=42)
    args = ap.parse_args(argv)

    if args.mpc:
        return run_mpc_cell(multi_pod=args.multipod, out_dir=args.out,
                            s=args.s, t=args.t, z=args.z, m=args.m)
    if args.all:
        failures, results = [], []
        for arch, cfg in ARCHS.items():
            for shape in applicable_shapes(cfg):
                try:
                    results.append(run_cell(arch, shape.name,
                                            multi_pod=args.multipod,
                                            out_dir=args.out))
                except Exception as e:
                    failures.append((arch, shape.name, str(e)[:500]))
                    print(f"[dryrun] FAIL {arch} × {shape.name}: {e}",
                          flush=True)
        if failures:
            raise SystemExit(f"{len(failures)} cells failed: "
                             f"{[(a, s) for a, s, _ in failures]}")
        return results
    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all / --mpc)")
    cfg = reduced(get_config(args.arch)) if args.reduced else None
    return run_cell(args.arch, args.shape, multi_pod=args.multipod,
                    out_dir=args.out, cfg=cfg)


if __name__ == "__main__":
    main()

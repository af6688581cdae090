"""Cost tally of a traced port program (FLOPs / HBM bytes / collective bytes).

The port has no HLO: it runs eager torch and hand-written kernels, so
there is no compiled module to parse.  The file keeps its name so that
the port mirrors the reference file for file.  It does what the
reference's analyzer is for: it counts a program's work.  The reference
parses HLO text.  The port runs the program once on ``meta`` tensors
under a ``TorchDispatchMode`` and tallies every aten op that the program
dispatches, plus the work that each kernel's meta branch reports
(:mod:`repro_torch.kernels.work`).  A Python loop runs its body once per
iteration, so each body is counted once per trip, as the reference
multiplies a ``while`` body by its trip count.  All numbers are for the
program as traced: to get one device's numbers, trace one device's shapes.

* **flops**: ``2·M·N·K`` per matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``matmul`` and ``einsum`` reach these), plus the kernels'
  operations.  Elementwise flops are left out, as the reference leaves
  them out.
* **hbm bytes**: operand plus result bytes of the major ops (products,
  reductions, gathers, scatters, sorts, index ops) plus twice the result
  of data-movement ops (copies, cats, slicing copies), plus
  the kernels' bytes.  Eager torch fuses nothing, so ``hbm_bytes_fused``
  also counts every other non-view op at its operands and result (each
  is its own fusion boundary).  ``hbm_bytes_unfused`` is the result
  bytes of every non-view op plus the kernels' bytes, the pessimistic
  bound.
* **collective bytes**: none.  A traced program is one device's; its
  collectives (the trainer's, the partitioner's the reference would
  insert) come from the specs in closed form
  (:func:`repro_torch.launch.dryrun.collective_bytes`), which fills these
  keys.

The reference's ``*_tpu`` keys halve the collectives that XLA's CPU
pipeline promotes from bf16 to fp32.  The port's collectives run in the
dtype that they are given, so those keys are dropped.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import work

_aten = torch.ops.aten

# products: (op, batched)
_PRODUCTS = {_aten.mm.default: False, _aten.addmm.default: False,
             _aten.bmm.default: True, _aten.baddbmm.default: True}

# the major ops: counted at operands + result (the reference's _MAJOR)
_MAJOR = {"mm", "addmm", "bmm", "baddbmm", "convolution", "sum", "mean",
          "amax", "amin", "max", "min", "logsumexp", "_log_softmax",
          "_softmax", "cumsum", "sort", "topk", "argmax", "argmin", "gather",
          "scatter", "scatter_add", "index", "index_put", "index_select",
          "index_add", "embedding", "embedding_dense_backward", "norm",
          "linalg_vector_norm", "_log_softmax_backward_data",
          "_softmax_backward_data", "nll_loss_forward", "nll_loss_backward"}

# data movement: counted at twice the result (read + write)
_MOVE = {"copy", "_to_copy", "clone", "cat", "stack", "slice_scatter",
         "select_scatter", "constant_pad_nd", "flip", "roll", "repeat",
         "contiguous", "index_copy", "masked_scatter"}

# ops that read or write nothing: metadata, views, factories
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
         "t", "squeeze", "unsqueeze", "slice", "select", "as_strided",
         "alias", "detach", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "split", "split_with_sizes",
         "unbind", "chunk", "narrow", "diagonal", "unfold", "lift_fresh",
         "_reshape_alias", "view_as_real", "view_as_complex", "movedim",
         "expand_as", "view_as", "resize", "set", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type",
         "zeros", "ones", "full", "scalar_tensor", "arange", "new_zeros",
         "new_ones", "new_full", "zeros_like", "ones_like", "full_like",
         "fill", "zero", "randn", "rand", "normal", "uniform", "randint",
         "_local_scalar_dense", "item"}


def _base(func) -> str:
    """``aten::add_.Tensor`` -> ``add``: the op's name without overload or
    the in-place underscore."""
    name = func._schema.name.split("::")[-1]
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _product_flops(func, args, out) -> int:
    """``2 · prod(result) · K`` of one product op."""
    batched = _PRODUCTS[func]
    lhs = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default) \
        else args[0]
    k = lhs.shape[2] if batched else lhs.shape[1]
    return 2 * out.numel() * k


class Tally(TorchDispatchMode):
    """Counts every aten op dispatched inside ``with Tally() as t:``, and
    the kernels' meta branches' work (:func:`repro_torch.kernels.work.
    record`); :meth:`summary` gives the reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.kernel_flops = 0
        self.hbm_min = 0
        self.hbm_fused = 0
        self.hbm_unfused = 0
        self.ops: Counter = Counter()
        self.kernels: Counter = Counter()
        self._hook = None

    def __enter__(self):
        self._hook = work.tallying(self._kernel)
        self._hook.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hook.__exit__(*exc)

    def _kernel(self, name: str, nbytes: int, ops: int) -> None:
        self.kernels[name] += 1
        self.kernel_flops += ops
        self.flops += ops
        self.hbm_min += nbytes
        self.hbm_fused += nbytes
        self.hbm_unfused += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _base(func)
        self.ops[name] += 1
        res = sum(_nbytes(x) for x in _tensors(out))
        if name in _FREE:
            return
        if func in _PRODUCTS:
            self.flops += _product_flops(func, args, out)
        operands = sum(_nbytes(x) for x in _tensors((args, kwargs)))
        self.hbm_unfused += res
        if name in _MAJOR:
            self.hbm_min += operands + res
            self.hbm_fused += operands + res
        elif name in _MOVE:
            self.hbm_min += 2 * res
            self.hbm_fused += 2 * res
        else:
            self.hbm_fused += operands + res

    def summary(self) -> dict:
        return {
            "flops": float(self.flops),
            "hbm_bytes": float(self.hbm_min),
            "hbm_bytes_fused": float(self.hbm_fused),
            "hbm_bytes_unfused": float(self.hbm_unfused),
            "collective_bytes": {},
            "collective_counts": {},
            "collective_total_bytes": 0,
            "n_computations": int(sum(self.ops.values())
                                  + sum(self.kernels.values())),
            "kernel_flops": float(self.kernel_flops),
            "kernel_calls": dict(self.kernels),
        }


def analyze(fn: Callable, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors, or any others)
    under a :class:`Tally` and return its :meth:`~Tally.summary`: the
    reference's keys, ``flops``, ``hbm_bytes``, ``hbm_bytes_fused``,
    ``hbm_bytes_unfused``, ``collective_bytes``, ``collective_counts``,
    ``collective_total_bytes`` and ``n_computations`` (ops dispatched,
    kernels included), and the port's ``kernel_flops`` and
    ``kernel_calls``."""
    with Tally() as tally:
        fn(*args, **kwargs)
    return tally.summary()

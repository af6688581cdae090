"""How one rank of the multi-rank trainer holds and reduces its leaves.

The reference's production step is the one-card loop jitted over a mesh
with the parameter specs of :func:`~.sharding.infer_param_specs`; XLA
inserts the collectives.  The port runs the same loop on every rank of a
``torch.distributed`` ``DeviceMesh`` over ``("pod", "data", "model")``
(any of them may be absent) and calls the collectives itself, per spec:

* each rank takes ``global_batch / (pod·data)`` rows (:meth:`Layout.rows`);
* a leaf whose spec splits a dim over ``data`` (the dim ``p_fsdp`` names)
  is held as this rank's slice of that dim between steps; before the
  forward it is all-gathered (:meth:`Layout.unshard_`), after the backward
  each rank receives every rank's part of its slice of the gradient (an
  all-to-all: a reduce-scatter's bytes), and AdamW updates the slice
  with moments of the slice's shape (FSDP);
* a leaf with no split dim is replicated, and every rank's gradient of
  it is all-gathered;
* each rank adds the parts from zero in rank order and divides once, as
  one rank's microbatch accumulation does, so every gradient, the loss
  and the clip norm (taken over whole gradients,
  :meth:`Layout.global_norm`) equal one rank's with ``microbatches =
  pod·data`` on the whole batch, to the bit;
* with ``compress_pod`` the sum runs over the pod's ranks (``data``),
  then :func:`~.compressed.compressed_psum` (int8 with error feedback)
  takes the mean over ``pod``.  The residuals it feeds back are the
  step's state (``AdamWState.feedback``, one per leaf, of the leaf's
  local shape): they differ from pod to pod, so a checkpoint holds every
  pod's (:meth:`Layout.saved`, :meth:`Layout.restored`).

The ``model`` axis must have size 1: the reference runs tensor
parallelism nowhere (its dry-run only compiles it), and the port's
dry-run reports it (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .. import spans
from .compressed import compressed_psum
from .sharding import infer_param_specs, mesh_shape

_ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_a2a = dist.all_to_all_single

#: the collectives every layout of this process has called, by kind
STATS = {"calls": Counter()}


def reset_stats() -> None:
    STATS["calls"] = Counter()


def _collective(kind: str, fn, *args, **kw):
    """``fn(*args, **kw)``, one collective, inside the span ``fsdp.<kind>``
    and counted in :data:`STATS`."""
    with spans.span("fsdp." + kind):
        out = fn(*args, **kw)
    STATS["calls"][kind] += 1
    return out


def _in_order(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in fp32, added from zero in order, as
    the one-rank step accumulates its microbatches."""
    acc = torch.zeros(parts.shape[1:], dtype=torch.float32, device=parts.device)
    for part in parts:
        acc.add_(part)
    return acc


def _split_dim(name: str, spec) -> Optional[int]:
    """The dim that ``spec`` splits over ``data``, or None; any other
    split axis is refused (it needs a ``model`` or ``pod`` axis above 1
    in a parameter spec, which the rules never give with ``model`` = 1)."""
    dim = None
    for i, ax in enumerate(spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        if not axes:
            continue
        if tuple(axes) != ("data",) or dim is not None:
            raise ValueError(f"{name}: the multi-rank trainer splits "
                             f"parameters over 'data' only, got {spec}")
        dim = i
    return dim


class Layout:
    """One rank's view of the trainer's leaves on a process mesh."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], mesh, *,
                 compress_pod: bool = False):
        sizes = mesh_shape(mesh)
        if sizes.get("model", 1) > 1:
            raise ValueError(
                f"the multi-rank trainer takes a 'model' axis of size 1, got "
                f"{sizes['model']}: tensor parallelism is reported by the "
                f"dry-run (repro_torch.launch.dryrun), not trained")
        unknown = set(sizes) - {"pod", "data", "model"}
        if unknown:
            raise ValueError(f"mesh axes {sorted(unknown)}: the trainer "
                             f"knows 'pod', 'data' and 'model'")
        if compress_pod and "pod" not in sizes:
            raise ValueError("compress_pod needs a 'pod' axis in the mesh")
        self.mesh = mesh
        self.data = sizes.get("data", 1)
        self.pod = sizes.get("pod", 1)
        self.world = self.data * self.pod
        self.compress_pod = compress_pod

        def group(axis):    # size 1 too: the collectives still launch
            return mesh.get_group(axis) if axis in sizes else None

        def local(axis):
            return mesh.get_local_rank(axis) if axis in sizes else 0

        self.data_group = group("data")
        self.pod_group = group("pod")
        # every rank, in batch order (the mesh covers the default group,
        # row-major over ("pod", "data"))
        self.world_group = dist.group.WORLD
        self.data_rank, self.pod_rank = local("data"), local("pod")
        self.rank = self.pod_rank * self.data + self.data_rank
        metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
        specs = infer_param_specs(metas, mesh)
        self.dims = {n: d for n, s in specs.items()
                     if (d := _split_dim(n, s)) is not None}
        self._local: Dict[str, torch.Tensor] = {}
        #: called, when set, with each compressed reduction's stages
        #: (``{name: compress_leaf's dict}``), for a check of them
        self.probe: Optional[Callable[[dict], None]] = None

    @classmethod
    def for_config(cls, cfg, mesh, **kw) -> "Layout":
        """The layout of ``cfg``'s whole weights (read on ``meta``)."""
        from ..models.api import get_model

        params = get_model(cfg).init_params(cfg, 0, device="meta")
        return cls({n: tuple(p.shape) for n, p in params.named_parameters()},
                   mesh, **kw)

    # ------------------------------------------------------------ rows --
    def rows(self, global_batch: int) -> Tuple[int, int]:
        """``(lo, hi)``: this rank's rows of the global batch (the batch
        axis splits over ``("pod", "data")``, row-major)."""
        if global_batch % self.world:
            raise ValueError(f"a global batch of {global_batch} rows does not "
                             f"split over {self.world} ranks")
        per = global_batch // self.world
        return self.rank * per, (self.rank + 1) * per

    # ---------------------------------------------------------- slices --
    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a leaf of ``name`` (its last ``/`` part a
        parameter name): a contiguous copy, or ``full`` itself when the
        leaf is not split."""
        name = name.rsplit("/", 1)[-1]
        dim = self.dims.get(name)
        if dim is None:
            return full
        c = full.shape[dim] // self.data
        return full.narrow(dim, self.data_rank * c, c).contiguous()

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice (a collective over
        ``data``); ``part`` itself when the leaf is not split."""
        dim = self.dims.get(name.rsplit("/", 1)[-1])
        if dim is None:
            return part
        moved = part.movedim(dim, 0).contiguous()
        full = moved.new_empty((moved.shape[0] * self.data, *moved.shape[1:]))
        _collective("all_gather", _ag, full, moved, group=self.data_group)
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def _per_pod(path: str) -> bool:
        """A residual of error feedback: one per pod (the leaves under a
        ``feedback`` key of a state)."""
        return "feedback" in path.split("/")[:-1]

    def saved(self, path: str, part: torch.Tensor) -> torch.Tensor:
        """The leaf at ``path`` of a state as a checkpoint holds it (a
        collective: every rank calls this): a split leaf whole, and a
        residual stacked over ``pod`` (``[pod, *whole]``)."""
        whole = self.gather(path, part)
        if self._per_pod(path):
            whole = self._every(whole.contiguous(), self.pod_group, self.pod)
        return whole

    def restored(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a leaf read from a checkpoint
        (:meth:`saved`'s inverse)."""
        if self._per_pod(path):
            full = full[self.pod_rank]
        return self.local_of(path, full)

    def zero_feedback(self, params: nn.Module) -> Dict[str, torch.Tensor]:
        """The residuals of a ``compress_pod`` step before its first
        reduction: fp32 zeros of every parameter's local shape (empty
        without ``compress_pod``)."""
        if not self.compress_pod:
            return {}
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.named_parameters()}

    def shard_(self, params: nn.Module) -> nn.Module:
        """Keep only this rank's slice of every split parameter."""
        for name, p in params.named_parameters():
            if name in self.dims:
                p.data = self.local_of(name, p.data)
                self._local[name] = p.data
        return params

    def unshard_(self, params: nn.Module) -> None:
        """All-gather every split parameter before the forward."""
        for name, p in params.named_parameters():
            if name in self.dims:
                self._local[name] = p.data
                p.data = self.gather(name, p.data)

    def reshard_(self, params: nn.Module) -> None:
        """Back to the slices (the gathered weights are dropped)."""
        for name, p in params.named_parameters():
            if name in self.dims:
                p.data = self._local[name]

    # ------------------------------------------------------- reductions --
    def _every(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` in rank order (an
        all-gather over ``group``; ``x`` itself for a group of one)."""
        if n == 1 and group is None:
            return x[None]
        flat = x.new_empty((n * x.numel(),))
        _collective("all_gather", _ag, flat, x.reshape(-1).contiguous(),
                    group=group)
        return flat.view(n, *x.shape)

    def _slices(self, moved: torch.Tensor, group, n: int) -> torch.Tensor:
        """``[n, c, ...]``: from every rank of ``group``, in rank order, the
        slice of its gradient (split along dim 0, ``data`` ways) that this
        rank keeps (an all-to-all: each rank sends each rank that one)."""
        c = moved.shape[0] // self.data
        dest = torch.arange(n, device=moved.device) % self.data
        send = moved.view(self.data, c, *moved.shape[1:])[dest]
        if n == 1 and group is None:
            return send
        recv = torch.empty_like(send)
        _collective("all_to_all", _a2a, recv, send, group=group)
        return recv

    def reduce(self, names: Sequence[str], grads: List[torch.Tensor],
               loss: torch.Tensor,
               feedback: Optional[Dict[str, torch.Tensor]] = None):
        """``(local grads, loss, feedback)``: each gradient in fp32 as the
        mean over all ranks (this rank's slice of it for a split leaf),
        the mean loss, and the residuals for the next step.  The ranks'
        parts are added from zero in rank order, as one rank's microbatch
        accumulation adds its microbatches, so the result is that rank's
        to the bit: a split leaf's slices come by an all-to-all (the bytes
        of a reduce-scatter when ``pod`` is 1), a replicated leaf's copies
        by an all-gather.  With ``compress_pod`` the sum runs over this
        pod's ranks, then :func:`~.compressed.compressed_psum` over
        ``pod``, fed ``feedback`` (this step's residuals); without it
        ``feedback`` passes through."""
        group, n = ((self.data_group, self.data) if self.compress_pod
                    else (self.world_group, self.world))
        out = {}
        for name, g in zip(names, grads, strict=True):
            g32 = g.to(torch.float32)
            dim = self.dims.get(name)
            if dim is None:
                out[name] = _in_order(self._every(g32, group, n))
            else:
                moved = g32.movedim(dim, 0).contiguous()
                mine = _in_order(self._slices(moved, group, n))
                out[name] = mine.movedim(0, dim).contiguous()
        if self.compress_pod:
            for g in out.values():
                g.div_(self.data)
            stages = {} if self.probe is not None else None
            out, feedback = _collective(
                "compressed_psum", compressed_psum, out, self.mesh,
                feedback or None, axis="pod", stages=stages)
            if stages is not None:
                self.probe(stages)
        else:
            for g in out.values():
                g.div_(self.world)
        losses = self._every(loss.to(torch.float32).reshape(()),
                             self.world_group, self.world)
        return ([out[n] for n in names], _in_order(losses) / self.world,
                feedback)

    def global_norm(self, names: Sequence[str],
                    grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """The norm of the whole gradients, or None when no leaf is split
        (AdamW then takes the norm itself).

        Summed as AdamW's :func:`~repro_torch.optim.adamw.global_norm`
        sums it, leaf by leaf over whole leaves, so that it equals one
        rank's to the bit: each split leaf's slices are all-gathered for
        it (one more fp32 all-gather, a leaf at a time).  Summing the
        slices' squares instead rounds in another order, and AdamW's
        update, nearly the sign of the gradient, turns that last-bit
        difference of the clip scale into flipped bf16 roundings and
        flipped signs of near-zero gradients within a few steps."""
        if not self.dims:
            return None
        total = 0
        for name, g in zip(names, grads, strict=True):
            whole = self.gather(name, g) if name in self.dims else g
            total = total + torch.sum(torch.square(whole.to(torch.float32)))
        return torch.sqrt(total)

    def barrier(self) -> None:
        dist.barrier()

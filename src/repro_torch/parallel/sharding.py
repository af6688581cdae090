"""Logical-axis sharding rules (FSDP / TP / EP / SP) with divisibility guards.

Production pattern: model code annotates activations with *logical* axis
names; a rules table maps logical → mesh axes; every mapping is guarded by a
divisibility check so an arch whose head count (say smollm's 15 q-heads)
does not divide the TP axis silently falls back to replication on that dim
instead of failing to partition.

Parameter shardings are inferred from path-name conventions
(:func:`infer_param_specs`) — FSDP shards the d_model-ish dim over ``data``,
TP shards heads/ffn/vocab/experts over ``model``.

Port of ``repro/parallel/sharding.py``, with the reference's names, rules
and order.  :class:`PartitionSpec` (``P``) and :class:`NamedSharding`
stand in for JAX's: a spec is a tuple whose entries are None, an axis
name or a tuple of axis names, and equals JAX's ``P`` turned into a
tuple.  A mesh is anything with a ``.shape`` mapping of axis name to
size: the port's :class:`~repro_torch.parallel.compat.Mesh`, a
``torch.distributed`` ``DeviceMesh`` (:func:`mesh_shape` reads it) or a
stand-in.  The port keeps one tensor per layer (``layers.3.w_q``) where
JAX stacks ``[L, ...]``, so a port leaf's spec is the JAX leaf's with its
leading ``p_stack`` None dropped.  The multi-rank trainer
(:mod:`repro_torch.parallel.fsdp`) splits each leaf as
:func:`named_sharding_tree` says.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Axis = Union[None, str, Tuple[str, ...]]

# logical activation axis -> mesh axis (may be tuple for multi-axis sharding)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,            # flipped to "model" under sequence parallelism
    "seq_kv": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": None,
    # parameter axes
    "p_fsdp": "data",       # FSDP dim (usually d_model)
    "p_tp": "model",        # TP dim (heads*hd / ffn / vocab)
    "p_experts": "model",
    "p_stack": None,        # stacked-layer leading dim
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per dim, None (replicated),
    an axis name, or a tuple of axis names (the dim split over their
    product)."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mesh: its ``.shape`` when that is a
    mapping (the port's ``Mesh``, the reference's ``FakeMesh``), else a
    ``DeviceMesh``'s ``mesh_dim_names`` against its ``.shape`` tuple."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape, strict=True))


class _ShapeView:
    """A mesh's axis sizes as ``.shape``, for the rules below."""

    def __init__(self, mesh):
        self.shape = mesh_shape(mesh)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Install mesh+rules for model-internal activation constraints."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def _present_size(mesh, axes: Tuple[str, ...]) -> int:
    out = 1
    for a in axes:
        if a in mesh.shape:
            out *= mesh.shape[a]
    return out


def _resolve(mesh, ax: Axis) -> Axis:
    """Drop mesh axes that don't exist (e.g. no 'pod' on single-pod)."""
    if ax is None:
        return None
    if isinstance(ax, str):
        return ax if ax in mesh.shape else None
    present = tuple(a for a in ax if a in mesh.shape)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh=None, rules: Optional[dict] = None) -> P:
    """PartitionSpec for ``shape`` given logical axis names (with guards)."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return P()
    if not isinstance(mesh.shape, Mapping):
        mesh = _ShapeView(mesh)
    spec = []
    used: set = set()
    for dim, name in zip(shape, logical, strict=True):
        ax = _resolve(mesh, rules.get(name)) if name else None
        if ax is None:
            spec.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else ax
        if any(a in used for a in axes):
            spec.append(None)
            continue
        size = _present_size(mesh, axes)
        if size > 1 and dim % size == 0:
            spec.append(ax)
            used.update(axes)
        else:
            spec.append(None)
    return P(*spec)


def get_rule(name: str, default=None):
    """Read a (possibly non-axis) knob from the active rule table."""
    return _CTX.rules.get(name, default)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: returns ``x`` unchanged.

    The reference hands the constraint to XLA's SPMD partitioner; the port
    has none.  Its trainer splits the batch axis by rank before the step
    (each rank runs the whole model on its rows), so the models need not
    call this; it stays for code written against the reference."""
    return x


# ------------------------------------------------------------ param specs --
# path-name convention -> logical dims (trailing dims; leading stacked dim
# auto-detected by rank).
_PARAM_PATTERNS = [
    ("embed", ("vocab", "p_fsdp")),
    ("lm_head", ("p_fsdp", "vocab")),
    ("w_qkv", ("p_fsdp", "p_tp")),
    ("w_q", ("p_fsdp", "p_tp")),
    ("w_k", ("p_fsdp", "p_tp")),
    ("w_v", ("p_fsdp", "p_tp")),
    ("w_o", ("p_tp", "p_fsdp")),
    ("moe_w1", ("p_experts", "p_fsdp", None)),
    ("moe_w3", ("p_experts", "p_fsdp", None)),
    ("moe_w2", ("p_experts", None, "p_fsdp")),
    ("router", ("p_fsdp", None)),
    ("w1", ("p_fsdp", "p_tp")),
    ("w3", ("p_fsdp", "p_tp")),
    ("w2", ("p_tp", "p_fsdp")),
    ("in_proj", ("p_fsdp", "p_tp")),
    ("out_proj", ("p_tp", "p_fsdp")),
    ("conv", (None, None)),
    ("norm", (None,)),
    ("scale", (None,)),
    ("bias", (None,)),
]


def _match_logical(name: str, rank: int):
    for pat, logical in _PARAM_PATTERNS:
        if pat in name:
            trailing = list(logical)
            pad = rank - len(trailing)
            if pad < 0:
                trailing = trailing[-rank:]
            return [None] * pad + trailing  # leading dims: stacked layers
    return [None] * rank


def _named_shapes(params) -> dict:
    """``{name: shape}`` of a module's named parameters or of a mapping of
    names to tensors (``meta`` tensors will do)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: tuple(x.shape) for name, x in params.items()}


def infer_param_specs(params, mesh, rules: Optional[dict] = None) -> dict:
    """``{name: PartitionSpec}`` for a module's parameters, or a
    ``{name: tensor}`` mapping, by path name (dotted: ``layers.3.w_q``)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return {name: spec_for(shape, _match_logical(name, len(shape)), mesh, rules)
            for name, shape in _named_shapes(params).items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec laid over a mesh."""

    mesh: Any
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a leaf of global ``shape``."""
        sizes = mesh_shape(self.mesh)
        out = []
        for i, dim in enumerate(shape):
            ax = self.spec[i] if i < len(self.spec) else None
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            out.append(dim // math.prod(sizes[a] for a in axes))
        return tuple(out)


def named_sharding_tree(params, mesh, rules: Optional[dict] = None) -> dict:
    """``{name: NamedSharding}``: where each parameter lives on ``mesh``."""
    specs = infer_param_specs(params, mesh, rules)
    return {name: NamedSharding(mesh, s) for name, s in specs.items()}

"""Distributed AGE-CMPC: the worker pool mapped onto a mesh axis.

Port of ``repro/mpc/secure_matmul.py``.  The paper's N edge workers become
N logical workers packed onto a named mesh axis (worker-major, padded to
``N_pad``, a multiple of the axis size D).  Phase 2's worker-to-worker
exchange of ``G_n(α_{n'})``, the dominant communication (eq. (17)), is one
reduce-scatter over that axis: every shard reduces its local workers'
contributions to every ``I(α_{n'})`` and keeps only its own chunk of n'.

The runner is single-controller, as the JAX one is: one process drives
every device of the :class:`~repro_torch.parallel.compat.Mesh`, one shard
body after another (:func:`~repro_torch.parallel.compat.shard_map`), and
the shards exchange chunks with ``Tensor.to``.  Each shard's body runs on
its own device's current stream:

* phase-1 shares of its ``N_pad/D`` workers: two ``polyeval`` launches
  against the shard's rows of the padded Vandermonde tables;
* ``H = F_A·F_B``: one ``modmatmul_batched`` launch at W = ``N_pad/D``;
* the G-mix and the mask term in one ``polyeval`` launch of the stacked
  form, ``[g_mix_t[:, local] | vand_g ⊗ 1_local]`` against ``(h_local,
  masks_local)``: the sum over the local workers' masks that the JAX
  ``einsum("mw,nwrc->mrc")`` takes happens inside the product.

Then the reduce-scatter: on the int32 wire the ring of
:func:`mod_ring_reduce_scatter` with the per-hop fold in the ``ring_fold``
kernel (D (D - 1) launches per block); on the int64 wire the
``psum_scatter`` form, the plain int64 sum of the D chunks and one ``% p``.
:meth:`ShardedCMPC.run` gathers the chunks onto ``mesh.devices[0]`` and
decodes there through the plan's decode stage (one more ``polyeval``).

``secure_matmul`` is the float facade (the legacy shim): float in, float
out, through :func:`~repro_torch.mpc.api.connect`.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import modmatmul as _kmm
from ..kernels import polyeval as _kpe
from ..kernels.ring_fold import ring_fold
from ..parallel.compat import Mesh, shard_map
from .api import MPCSpec
from .field import Field, as_int64, fold_in, generator
from .protocol import AGECMPCProtocol

WIRE_DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _pad_to(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _chunks(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    n = len(xs)
    return [x.reshape((n, -1) + tuple(x.shape[1:])) for x in xs]


def mod_ring_reduce_scatter(xs: Sequence[torch.Tensor], p: int
                            ) -> List[torch.Tensor]:
    """Reduce-scatter of field elements with a modular fold at every hop.

    ``xs[j]`` is shard j's payload ``[D * chunk, ...]`` (int32 or int64
    field elements, < p) on shard j's device.  Returns, for every shard
    ``me``, the sum over all shards of chunk ``me``, mod p, on its own
    device, in the payload's type.  As in JAX: the permutation ``j → j-1``
    (shard ``me`` receives shard ``me+1``'s accumulator), the accumulator
    starting at chunk ``me+1``, and after D - 1 hops each shard holding
    its own chunk's sum.  Folding at every hop keeps an int32 payload
    int32 (half the bytes of the int64 collective).  Each fold is one
    ``ring_fold`` launch, into a fresh tensor: on a mesh that repeats a
    device a hop moves nothing, and the received accumulator is the
    sender's own tensor.
    """
    n = len(xs)
    parts = _chunks(xs)
    if n == 1:
        return [parts[0][0]]
    devs = [x.device for x in xs]

    def my_chunk(me: int, s: int) -> torch.Tensor:
        return parts[me][(me + 1 + s) % n]

    acc = [my_chunk(me, 0) for me in range(n)]
    for s in range(1, n):
        recv = [acc[(me + 1) % n].to(devs[me]) for me in range(n)]
        acc = [ring_fold(recv[me], my_chunk(me, s), p=p) for me in range(n)]
    return acc


def psum_scatter(xs: Sequence[torch.Tensor], p: int) -> List[torch.Tensor]:
    """The int64 wire's reduce-scatter, ``jax.lax.psum_scatter(...,
    tiled=True) % p``: shard ``me`` receives every shard's chunk ``me``,
    sums them in int64 and folds once.  ``xs`` as for
    :func:`mod_ring_reduce_scatter`, int64."""
    n = len(xs)
    parts = _chunks(xs)
    devs = [x.device for x in xs]
    return [torch.remainder(
        torch.stack([parts[j][me].to(devs[me]) for j in range(n)]).sum(0), p)
        for me in range(n)]


@dataclasses.dataclass(frozen=True)
class ShardedCMPC:
    """One protocol instance bound to a mesh axis.

    Workers ``0..N-1`` are padded to ``N_pad`` (a multiple of the axis
    size) and laid out worker-major, so shard d owns workers ``d·(N_pad/D)
    .. (d+1)·(N_pad/D)-1``.  Padded workers have all-zero Vandermonde rows
    and G-mix rows and columns: they contribute nothing but their masks,
    which are drawn and summed into the mask term as JAX does.

    ``wire_dtype``: ``"int64"`` (the ``psum_scatter`` form) or ``"int32"``
    (the ring with a fold per hop: half the payload).  ``prg_masks``: each
    worker draws its ``[z, m/t, m/t]`` phase-2 mask on its shard's device
    from a ``torch.Generator`` seeded with ``fold_in(key, worker)``,
    instead of shipping it from ``mesh.devices[0]``.  ``Y`` does not
    depend on the masks.
    """

    proto: AGECMPCProtocol
    mesh: Mesh
    axis: str = "model"
    wire_dtype: str = "int64"
    prg_masks: bool = False

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {sorted(WIRE_DTYPES)}"
                             f", got {self.wire_dtype!r}")
        self.mesh.axis_devices(self.axis)    # raises for an unknown axis

    @classmethod
    def from_spec(cls, spec: MPCSpec, mesh: Mesh, *, axis: str = "model",
                  m: Optional[int] = None, **kw) -> "ShardedCMPC":
        """A sharded runner for one spec (block side ``m`` or ``spec.m``);
        ``kw`` passes ``wire_dtype`` and ``prg_masks`` through."""
        return cls(AGECMPCProtocol.from_spec(spec, m=m), mesh, axis, **kw)

    @property
    def spec(self) -> MPCSpec:
        return self.proto.spec

    @property
    def axis_size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def n_pad(self) -> int:
        d = self.axis_size
        return -(-self.proto.n_workers // d) * d

    # ------------------------------------------------------ padded constants
    def _padded(self, arr: np.ndarray, axes=(0,)) -> np.ndarray:
        out = arr
        for ax in axes:
            out = _pad_to(out, self.n_pad, axis=ax)
        return out

    def _consts(self) -> Dict[str, np.ndarray]:
        pr = self.proto
        return dict(
            vand_a=self._padded(pr.vand_a),             # [Np, ts+z]
            vand_b=self._padded(pr.vand_b),             # [Np, ts+z]
            g_mix=self._padded(pr.g_mix, axes=(0, 1)),  # [Np, Np']
            vand_g=self._padded(pr.vand_g_secret),      # [Np, z]
        )

    @cached_property
    def _shard_tables(self) -> List[Dict[str, torch.Tensor]]:
        """Each shard's tables on its device: its rows of ``vand_a`` and
        ``vand_b``, and its exchange table ``[g_mix_t[:, local] | vand_g
        tiled once per local worker]``, ``[Np, nl·(1 + z)]``."""
        c = self._consts()
        nl = self.n_pad // self.axis_size
        out = []
        for d, dev in enumerate(self.mesh.axis_devices(self.axis)):
            local = slice(d * nl, (d + 1) * nl)
            exchange = np.concatenate(
                [c["g_mix"][local].T, np.tile(c["vand_g"], (1, nl))], axis=1)
            host = {"vand_a": c["vand_a"][local], "vand_b": c["vand_b"][local],
                    "exchange": exchange}
            out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                        for k, v in host.items()})
        return out

    # -------------------------------------------------------------- the step
    def build_step(self) -> Callable:
        """Returns ``step(terms_a, terms_b, masks) -> I points [Np, m/t,
        m/t]`` (int64, on ``mesh.devices[0]``).

        * ``terms_a: [ts+z, m/t, m/s]``: Aᵀ blocks then secret blocks
          (replicated: every shard evaluates its own workers' shares);
          ``terms_b: [ts+z, m/s, m/t]``.  Tensors or arrays, int32 on the
          int32 wire; they travel to each shard in their own type.
        * ``masks``: the per-worker phase-2 masks ``[Np, z, m/t, m/t]``,
          or with ``prg_masks`` the per-worker seeds ``[Np]``.
        """
        pr = self.proto
        p = pr.field.p
        z, mt, ms = pr.z, pr.m // pr.t, pr.m // pr.s
        nl = self.n_pad // self.axis_size
        wire = WIRE_DTYPES[self.wire_dtype]
        prg = self.prg_masks
        tables = self._shard_tables
        dev0 = self.mesh.devices[0]

        def local(shard, dev, terms_a, terms_b, masks):
            tab = tables[shard]
            ta = terms_a.to(dev).to(torch.int64).reshape(-1, mt * ms).contiguous()
            tb = terms_b.to(dev).to(torch.int64).reshape(-1, ms * mt).contiguous()
            # phase 1: the local workers' shares
            f_a = _kpe.polyeval(tab["vand_a"], ta, p=p).reshape(nl, mt, ms)
            f_b = _kpe.polyeval(tab["vand_b"], tb, p=p).reshape(nl, ms, mt)
            # phase 2 compute: H(α_n) = F_A·F_B
            h = _kmm.modmatmul_batched(f_a, f_b, p=p)
            if prg:
                mk = torch.empty((nl, z, mt, mt), dtype=torch.int64, device=dev)
                for i, seed in enumerate(masks[shard * nl:(shard + 1) * nl]):
                    g = generator(int(seed), dev)
                    torch.randint(0, p, mk[i].shape, generator=g, out=mk[i])
            else:
                mk = masks[shard * nl:(shard + 1) * nl].to(dev).to(torch.int64)
            # phase 2 exchange: every n' from the local workers' H and masks
            g_all = _kpe.polyeval(
                tab["exchange"], (h.reshape(nl, mt * mt),
                                  mk.reshape(nl * z, mt * mt).contiguous()),
                p=p)                                          # [Np, mt²]
            return g_all.to(wire)

        shards = shard_map(local, self.mesh, self.axis)

        def step(terms_a, terms_b, masks):
            if not prg:
                masks = _as_tensor(masks)
            g_alls = shards(_as_tensor(terms_a), _as_tensor(terms_b), masks)
            if wire == torch.int32:
                i_local = mod_ring_reduce_scatter(g_alls, p)
            else:
                i_local = psum_scatter(g_alls, p)
            i_pts = torch.cat([x.to(dev0).to(torch.int64) for x in i_local])
            return i_pts.reshape(self.n_pad, mt, mt)

        return step

    @cached_property
    def _step(self) -> Callable:
        return self.build_step()

    def run(self, a, b, key, *, survivors: Optional[np.ndarray] = None):
        """The full distributed run: phases 1-2 on the mesh, decode on
        ``mesh.devices[0]``.  ``key`` is an int seed or a
        ``torch.Generator`` on that device; the secrets (and the masks,
        without ``prg_masks``) are drawn from it."""
        pr = self.proto
        dev = self.mesh.devices[0]
        a, b = as_int64(a, dev), as_int64(b, dev)
        gen = generator(key, dev)
        mt, ms = pr.m // pr.t, pr.m // pr.s
        sec_a = pr.field.random(gen, (pr.z, mt, ms))
        sec_b = pr.field.random(gen, (pr.z, ms, mt))
        terms_a = torch.cat([pr._split_a(a), sec_a])
        terms_b = torch.cat([pr._split_b(b), sec_b])
        if self.prg_masks:
            masks = [fold_in(key, w) for w in range(self.n_pad)]
        else:
            masks = pr.field.random(gen, (self.n_pad, pr.z, mt, mt))
        if self.wire_dtype == "int32":
            terms_a = terms_a.to(torch.int32)
            terms_b = terms_b.to(torch.int32)
            if not self.prg_masks:
                masks = masks.to(torch.int32)
        i_pts = self._step(terms_a, terms_b, masks)
        return pr.decode(i_pts[: pr.n_workers], survivors, device=dev)


# ------------------------------------------------------------- float facade
def secure_matmul(a, b, *, s: int, t: int, z: int,
                  field: Optional[Field] = None,
                  mesh: Optional[Mesh] = None, axis: str = "model",
                  key=None, scheme: str = "age", device=None):
    """``AᵀB`` for real-valued square ``a, b`` via CMPC (legacy shim).

    Delegates to :func:`repro_torch.mpc.api.connect`: the spec pins the
    block side to ``a.shape[0]``, so the session maps the call onto exactly
    one coded block that consumes ``key`` (default 0) directly, equal bit
    for bit to ``encode → AGECMPCProtocol.run → decode``.  With ``mesh``
    given, phases 1-2 run sharded over ``axis`` and the session runs on
    ``mesh.devices[0]``; otherwise the local backend runs on ``device``
    (default the card).
    """
    from .api import connect

    a = torch.as_tensor(a)
    spec = MPCSpec(s=s, t=t, z=z, scheme=scheme, m=int(a.shape[0]),
                   **({"field": field} if field else {}))
    if mesh is not None:
        sess = connect(spec, backend="sharded", mesh=mesh, axis=axis,
                       device=device)
    else:
        sess = connect(spec, backend="local", device=device)
    key = key if key is not None else 0
    return sess.matmul(a.T, b, key=key).to(a.dtype)

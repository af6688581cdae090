"""Modular matrix products on the card: the phase-2 worker hot loop.

``O = (A @ B) mod p`` for field elements (int64 storage, values < p).

Port of ``repro/kernels/modmatmul.py``.  Three CUDA kernels replace the
Pallas kernels, and :func:`choose_instance` picks one from the shapes alone
before any launch:

* ``tensor_core`` (``csrc/modmatmul_tc.cu``): the product over 8-bit limbs
  on the int8 tensor cores (wgmma with A from registers, B by TMA
  multicast to a 2-CTA cluster; a persistent grid whose walk
  :func:`tc_grid` sizes and :func:`tc_tiles` spells out), for every
  product whose output fills its 64x64 tiles (the main path's
  ``[17,1024,1024]²``);
* ``skinny`` (``csrc/modmatmul_skinny.cu``): a streaming reduction for an
  output of at most :data:`SKINNY_N` columns (the MAC tags'
  ``[17, 2^20] @ [2^20, 1]``, and a wave's ``[B, 17, 2^20] @ [B, 2^20,
  1]``): each block sums :func:`skinny_rows` rows of A against a slice of
  K with 16-byte loads, every byte read once, and a second pass adds the
  :func:`skinny_blocks` blocks' partials;
* ``cuda_core`` (``csrc/modmatmul.cu``): one block per (worker, 64×64
  output tile) loops over K with shared-memory tiles and a register
  micro-tile, folding with ``mod_p`` every ``acc_window(p)`` products, and
  splits K across blocks when the output tiles cannot fill the card
  (:func:`k_splits`): every other shape.

Each source states its bound and design.  Two wrappers:

* :func:`modmatmul_batched` — all W workers' ``[M,K] @ [K,N]`` in one
  launch (``worker_compute``'s product);
* :func:`modmatmul` — one product, the ``W = 1`` launch.

Each wrapper checks its operands, allocates the output (and the instances'
scratch: limb planes, partial sums) with ``torch.empty``, launches on the current
stream and counts the launch in its ``launches`` attribute and in
``instances[name]``.  A CPU tensor takes the plain version
(:func:`modmatmul_plain`, the :mod:`repro_torch.kernels.barrett` ops); a
CUDA tensor launches the chosen kernel or raises: nothing falls back.
:func:`modmatmul_tc_emulation` repeats the tensor-core instance's integer
schedule in plain torch for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..mpc.errors import InvariantError, ShapeContractError
from ..mpc.field import acc_window
from . import _build, work
from .barrett import matmul_plain, mod_p


def modmatmul_plain(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """The plain version: exact ``(a @ b) mod p`` from the barrett ops,
    batched over leading dims, on any device."""
    return matmul_plain(a, b, p=p, window=acc_window(p))


INSTANCES = ("tensor_core", "skinny", "cuda_core")

TC_TILE = 64       # modmatmul_tc.cu's output tile side (BM = BN)
TC_CLUSTER = 2     # its CTAs a cluster (CLUSTER), side by side along M
LIMBS = 4          # 8-bit limbs per element: any p < 2^32
# The longest K-run whose diagonal sums fit the s32 accumulators: a diagonal
# holds at most 4 limb pairs, and 4·255²·8256 < 2^31 <= 4·255²·8257.
K_RUN_MAX = 8256
# The fold reduces once after the diagonals above this one (FOLD_LOW in
# modmatmul_tc.cu): mod_p(D_6 2^32 + … + D_2) 2^16 + D_1 2^8 + D_0 + R.
TC_FOLD_LOW = 2
TILE = 64          # output tile side of one block (BM = BN in modmatmul.cu)
TILE_K = 32        # K depth staged per shared-memory pass (BK)
MIN_SPLIT_K = 512  # fewest K rows worth a block of their own
MAX_GRID_Z = 65535
SKINNY_N = 4       # widest output the skinny instance takes
# rows of A one skinny block sums, by output width (its kernel instances)
SKINNY_ROWS = {1: (8, 20, 32), 2: (8, 16), 4: (8,)}
SKINNY_THREADS = 256
SKINNY_PER_SM = 6      # blocks per SM over the whole grid: three waves of two
SKINNY_MIN_STEPS = 8   # K steps (of 2 elements) each thread takes at least
MAX_GRID_X = 2**31 - 1


def skinny_rows(m: int, n: int) -> int:
    """R, the rows of A one skinny block sums: the smallest instance that
    covers all M rows in one pass, else the largest (M / R passes)."""
    opts = SKINNY_ROWS[1 if n == 1 else (2 if n == 2 else 4)]
    return next((r for r in opts if m <= r), opts[-1])


def skinny_blocks(w: int, m: int, k: int, n: int, sms: int) -> int:
    """G, the blocks that share one lane's K.

    About :data:`SKINNY_PER_SM` blocks per SM over the whole grid (W lanes
    x passes), three waves of the two resident ones, so the last wave's
    tail is short; but each thread takes at least
    :data:`SKINNY_MIN_STEPS` steps of K, so a block's start and its
    reduction stay a small share of its life.  On an H100 the tags'
    ``[17, 2^20] @ [2^20, 1]`` gets 256 blocks and an 8-lane wave 99 per
    lane (PERF.md)."""
    passes = -(-m // skinny_rows(m, n))
    want = -(-SKINNY_PER_SM * sms // max(w * passes, 1))
    most = -(-k // (SKINNY_THREADS * 2 * SKINNY_MIN_STEPS))
    return max(1, min(want, most, MAX_GRID_X))


def k_splits(w: int, m: int, k: int, n: int, sms: int):
    """``(splits, k_chunk)``: how many blocks share each output tile's K.

    One block per output tile (``splits = 1``) as long as the tiles give
    every SM two blocks.  Below that (a skinny product such as the MAC
    tags' ``[N, (m/t)²] @ [(m/t)², 1]``) K is cut into chunks of at least
    :data:`MIN_SPLIT_K` rows, a multiple of :data:`TILE_K`, so the grid
    reaches about two blocks per SM.
    """
    tiles = w * -(-m // TILE) * -(-n // TILE)
    want = min(-(-2 * sms // tiles), k // MIN_SPLIT_K, MAX_GRID_Z // max(w, 1))
    if want <= 1:
        return 1, max(k, 1)
    chunk = -(-k // want)
    chunk = -(-chunk // TILE_K) * TILE_K
    return -(-k // chunk), chunk


def choose_instance(w: int, m: int, k: int, n: int) -> str:
    """The kernel that serves a ``[W,M,K] @ [W,K,N]`` product on the card.

    ``"tensor_core"`` when its 64×64 output tile is full in both M and N
    (and the grid fits); ``"skinny"`` for an output of at most
    :data:`SKINNY_N` columns (the ``tags`` stage's N = 1); ``"cuda_core"``
    for the rest, such as a tiny ragged product.  A pure function of the
    shapes.
    """
    if (m >= TC_TILE and n >= TC_TILE and k >= 1 and w <= MAX_GRID_Z
            and -(-m // TC_TILE) <= MAX_GRID_Z):
        return "tensor_core"
    if (1 <= n <= SKINNY_N and k >= 1 and w <= MAX_GRID_Z
            and -(-m // skinny_rows(m, n)) <= MAX_GRID_Z):
        return "skinny"
    return "cuda_core"


def tc_grid(w: int, m: int, n: int, sms: int):
    """``(clusters, m_pairs, n_tiles)``: the tensor-core instance's grid.

    Its unit of work is one worker's pair of 64-row M-tiles (one a CTA of
    a :data:`TC_CLUSTER`-CTA cluster; the last pair of an odd count has
    one) by one 64-column N-tile.  One cluster per pair of the ``sms`` SMs
    that hold the kernel's clusters at once, or one per unit where there
    are fewer units; each cluster walks the units
    :func:`tc_tiles` lists.  A pure function of the shapes and the SMs."""
    m_pairs = -(-(-(-m // TC_TILE)) // TC_CLUSTER)
    n_tiles = -(-n // TC_TILE)
    units = w * m_pairs * n_tiles
    return max(1, min(units, sms // TC_CLUSTER)), m_pairs, n_tiles


def tc_tiles(w: int, m: int, n: int, sms: int):
    """Yield ``(cta, (worker, m_tile, n_tile))`` for every output tile the
    tensor-core kernel stores, CTA by CTA in the order each walks them:
    cluster ``c`` takes units ``c, c + clusters, …`` numbered worker by
    worker, then N-tile, then M-tile pair, and its CTA ``r`` the pair's
    M-tile ``2 q + r`` (the kernel's ``unit_at``)."""
    clusters, m_pairs, n_tiles = tc_grid(w, m, n, sms)
    m_tiles = -(-m // TC_TILE)
    units = w * m_pairs * n_tiles
    for c in range(clusters):
        for u in range(c, units, clusters):
            worker, r = divmod(u, m_pairs * n_tiles)
            n_tile, pair = divmod(r, m_pairs)
            for rank in range(TC_CLUSTER):
                m_tile = TC_CLUSTER * pair + rank
                if m_tile < m_tiles:
                    yield c * TC_CLUSTER + rank, (worker, m_tile, n_tile)


def modmatmul_tc_emulation(a: torch.Tensor, b: torch.Tensor, *, p: int,
                           run: int = K_RUN_MAX) -> torch.Tensor:
    """The tensor-core instance's integer schedule in plain torch.

    Splits every element into four unsigned 8-bit limbs, sums each diagonal
    ``D_d = Σ_{i+j=d} A_i @ B_j`` exactly in int64 over K-runs of ``run``
    products, raises ``OverflowError`` if a run's diagonal would leave the
    kernel's s32 accumulator (``>= 2^31``), and folds each run by Horner
    over the diagonals with the kernel's two reductions,
    ``R <- mod_p(mod_p(D_6·2^32 + … + D_2)·2^16 + D_1·2^8 + D_0 + R)``
    (:data:`TC_FOLD_LOW`); ``OverflowError`` too if the diagonals' maxima
    could take the first argument past ``mod_p``'s domain.  Elements may be
    any value in ``[0, 2^32)``.  The CPU tests hold it to the JAX kernels;
    the port never calls it.
    """
    a, b = a.to(torch.int64), b.to(torch.int64)
    al = [(a >> (8 * i)) & 0xFF for i in range(LIMBS)]
    bl = [(b >> (8 * j)) & 0xFF for j in range(LIMBS)]
    k = a.shape[-1]
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.int64,
                      device=a.device)
    for k0 in range(0, k, run):
        cut = slice(k0, k0 + run)
        where = f"the K-run [{k0}, {min(k, k0 + run)})"
        diag = [torch.zeros_like(out) for _ in range(2 * LIMBS - 1)]
        for i in range(LIMBS):
            for j in range(LIMBS):
                diag[i + j] += al[i][..., cut] @ bl[j][..., cut, :]
        tops = [int(d.max()) if out.numel() else 0 for d in diag]
        if max(tops) >= 2**31:
            raise OverflowError(f"a diagonal of {where} reaches {max(tops)} "
                                f">= 2^31")
        if sum(t << (8 * (d - TC_FOLD_LOW))
               for d, t in enumerate(tops) if d >= TC_FOLD_LOW) >= 2**63:
            raise OverflowError(f"the high diagonals of {where} may leave "
                                f"mod_p's domain (2^63)")
        high = diag[-1]
        for d in reversed(diag[TC_FOLD_LOW:-1]):
            high = high * 256 + d
        acc = mod_p(high, p)
        for d in reversed(diag[:TC_FOLD_LOW]):
            acc = acc * 256 + d
        out = mod_p(acc + out, p)
    return out


def check_k_run(run: Optional[int] = None) -> int:
    """Hold a tensor-core K-run (default :data:`K_RUN_MAX`) to the overflow
    proof's (:func:`repro_torch.analysis.overflow.certified_k_run`): raise
    ``InvariantError`` unless they agree, since a longer run wraps the s32
    diagonals and gives a wrong product with no error."""
    # lazy: the analysis package imports this module's constants
    from ..analysis.overflow import certified_k_run

    run = K_RUN_MAX if run is None else run
    cert = certified_k_run()
    if run != cert:
        raise InvariantError(
            f"K_RUN_MAX = {run} but the overflow proof certifies a K-run "
            f"of {cert}: the tensor-core schedule has drifted")
    return cert


@functools.lru_cache(maxsize=None)
def _certified_run() -> int:
    """:func:`check_k_run` once, at the first tensor-core launch."""
    return check_k_run()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("modmatmul")
    fn = lib.modmatmul_batched_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib_tc():
    lib = _build.load("modmatmul_tc")
    fn = lib.modmatmul_tc_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.modmatmul_tc_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tc_sms(index: int) -> int:
    """The SMs the tensor-core kernel's clusters fill at once on card
    ``index``: :data:`TC_CLUSTER` times the clusters it holds."""
    with torch.cuda.device(index):
        clusters = _lib_tc().modmatmul_tc_clusters()
    if clusters < 1:
        raise _build.KernelLaunchError(
            f"modmatmul (tensor_core): the card holds no cluster of the "
            f"kernel (cudaError_t {-clusters})")
    return TC_CLUSTER * clusters


@functools.lru_cache(maxsize=None)
def _lib_skinny():
    fn = _build.load("modmatmul_skinny").modmatmul_skinny_launch
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, ndim: int, what: str) -> None:
    for x in (a, b):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f"{what} takes int64 tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
        if x.ndim != ndim:
            raise ShapeContractError(
                f"{what} takes {ndim}-D operands: {tuple(a.shape)} @ "
                f"{tuple(b.shape)}", shapes=(a.shape, b.shape))
        if not x.is_contiguous():
            raise ValueError(f"{what} takes contiguous operands")
    if a.device != b.device:
        raise ValueError(f"{what} operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what} runs on cpu or cuda, not {a.device}")
    lead_ok = ndim == 2 or a.shape[0] == b.shape[0]
    if a.shape[-1] != b.shape[-2] or not lead_ok:
        raise ShapeContractError(
            f"{what} operands disagree: {tuple(a.shape)} @ {tuple(b.shape)}",
            shapes=(a.shape, b.shape))


def _launch_cuda_core(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    w, m, k = a.shape
    n = b.shape[2]
    args = _build.fold_args(p)
    splits, chunk = k_splits(w, m, k, n, _sm_count(a.device.index))
    out = torch.empty((w, m, n), dtype=torch.int64, device=a.device)
    # per-split partials, each < p; summed mod p by the kernel's second pass
    part = (torch.empty((splits, w, m, n), dtype=torch.int64, device=a.device)
            if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     None if part is None else part.data_ptr(),
                     w, m, k, n, splits, chunk, *args, stream)
    _build.check(err, "modmatmul (cuda_core)")
    return out


def _launch_tensor_core(a: torch.Tensor, b: torch.Tensor, *,
                        p: int) -> torch.Tensor:
    _certified_run()
    w, m, k = a.shape
    n = b.shape[2]
    p_, bits, c, n_folds, _ = _build.fold_args(p)
    kp = -(-k // 16) * 16        # limb-plane row stride: TMA wants 16 bytes
    clusters, _, _ = tc_grid(w, m, n, _tc_sms(a.device.index))
    out = torch.empty((w, m, n), dtype=torch.int64, device=a.device)
    a_limbs = torch.empty((w, LIMBS, m, kp), dtype=torch.uint8, device=a.device)
    b_limbs = torch.empty((w, LIMBS, n, kp), dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib_tc().modmatmul_tc_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a_limbs.data_ptr(),
            b_limbs.data_ptr(), w, m, k, n, kp, clusters, p_, bits, c, n_folds,
            stream)
    _build.check(err, "modmatmul (tensor_core)")
    return out


def _launch_skinny(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    w, m, k = a.shape
    n = b.shape[2]
    if not 1 <= n <= SKINNY_N:
        raise ShapeContractError(
            f"the skinny instance takes outputs of 1 to {SKINNY_N} columns, "
            f"got {n}", shapes=(a.shape, b.shape))
    rows = skinny_rows(m, n)
    g = skinny_blocks(w, m, k, n, _sm_count(a.device.index))
    out = torch.empty((w, m, n), dtype=torch.int64, device=a.device)
    # per-block partials, each < p; summed mod p by the second pass
    part = (torch.empty((g, w, m, n), dtype=torch.int64, device=a.device)
            if g > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib_skinny()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None if part is None else part.data_ptr(),
                            w, m, k, n, rows, g, *_build.fold_args(p), stream)
    _build.check(err, "modmatmul (skinny)")
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, *, p: int,
            instance: str) -> torch.Tensor:
    """Launch one instance on ``[W,M,K] @ [W,K,N]`` CUDA operands, uncounted:
    the wrappers' path after :func:`choose_instance`, and the way to time or
    check an instance the chooser would not pick."""
    if instance == "tensor_core":
        return _launch_tensor_core(a, b, p=p)
    if instance == "skinny":
        return _launch_skinny(a, b, p=p)
    if instance == "cuda_core":
        return _launch_cuda_core(a, b, p=p)
    raise ValueError(f"unknown modmatmul instance {instance!r}; "
                     f"known: {INSTANCES}")


def _counted(fn, a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    instance = choose_instance(a.shape[0], a.shape[1], a.shape[2], b.shape[2])
    out = _launch(a, b, p=p, instance=instance)
    _build.count(fn, instance)
    return out


def _meta(a: torch.Tensor, b: torch.Tensor, p: int, what: str) -> torch.Tensor:
    """The meta branch: an empty ``[W, M, N]`` result whose work goes to
    the tally (:mod:`.work`); nothing launches."""
    w, m, k = a.shape
    n = b.shape[2]
    work.record(what, *work.mm_work(w, m, k, n, p))
    return a.new_empty((w, m, n))


def modmatmul_batched(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """``(a[w] @ b[w]) mod p`` for every worker ``w`` in one launch.

    ``a: [W, M, K]``, ``b: [W, K, N]`` contiguous int64 field elements
    (< p) on one device.  Returns ``[W, M, N]`` int64.
    """
    _check(a, b, 3, "modmatmul_batched")
    if a.device.type == "meta":
        return _meta(a, b, p, "modmatmul_batched")
    if a.device.type == "cpu":
        return modmatmul_plain(a, b, p=p)
    return _counted(modmatmul_batched, a, b, p)


def modmatmul(a: torch.Tensor, b: torch.Tensor, *, p: int) -> torch.Tensor:
    """``(a @ b) mod p`` for one ``[M, K] @ [K, N]`` product: the
    kernels' ``W = 1`` launch.  Same operand contract as
    :func:`modmatmul_batched`."""
    _check(a, b, 2, "modmatmul")
    if a.device.type == "meta":
        return _meta(a[None], b[None], p, "modmatmul")[0]
    if a.device.type == "cpu":
        return modmatmul_plain(a, b, p=p)
    return _counted(modmatmul, a[None], b[None], p)[0]


for _fn in (modmatmul_batched, modmatmul):
    _fn.launches = 0
    _fn.instances = dict.fromkeys(INSTANCES, 0)

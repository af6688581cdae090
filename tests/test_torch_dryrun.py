"""The port's dry-run (``launch/hlo_analysis.py``, ``specs.py``,
``dryrun.py``) on the CPU, against JAX's where the two count the same
thing.

* The tally equals JAX's loop-aware ``analyze`` exactly on the programs
  of ``tests/test_hlo_analysis.py``: a matmul, a batched dot, a loop of L
  products (the port's Python loop against JAX's ``scan``) and a loop of
  loops.
* ``build_cell`` gives train, prefill and decode cells for every family
  (reduced configs) on a ``(2, 2, 4)`` mesh of ``meta`` devices, and each
  traces through the kernels' meta branches.
* On a one-device mesh, the reduced llama3.2-1b train cell's argument
  bytes equal JAX's ``memory_analysis().argument_size_in_bytes``
  exactly, and its FLOPs lie within 10 % of JAX's ``analyze`` (measured:
  the port counts 2.25 % more, its flash kernel's causal pairs and the
  backward's five products against XLA's dots).
* ``dryrun.main`` runs one reduced cell and one reduced ``--mpc`` cell
  and writes their JSON; the meta branches launch nothing (every launch
  counter stays 0) and report the work formulas of ``kernels/work.py``.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.hlo_analysis import analyze as j_analyze
from repro.launch.specs import build_cell as j_build_cell
from repro.models.config import ShapeConfig as JShape
from repro.parallel.sharding import sharding_ctx as j_sharding_ctx
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import launch_counts, reset_launch_counts, work
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.modmatmul import modmatmul_batched
from repro_torch.kernels.polyeval import polyeval
from repro_torch.kernels.ring_fold import ring_fold
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import Tally, analyze
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.config import ShapeConfig

FAMILIES = ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-1.6b", "jamba-v0.1-52b",
            "whisper-small", "phi-3-vision-4.2b"]
KINDS = [ShapeConfig("t", 64, 8, "train"), ShapeConfig("p", 64, 8, "prefill"),
         ShapeConfig("d", 64, 8, "decode")]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _jax_flops(fn, *args):
    return j_analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


# -------------------------------------------------------------- the tally --
def test_tally_equals_analyze_on_a_matmul():
    a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    b = jax.ShapeDtypeStruct((256, 64), jnp.float32)
    want = _jax_flops(lambda a, b: a @ b, a, b)
    got = analyze(lambda a, b: a @ b, _meta(128, 256), _meta(256, 64))
    assert got["flops"] == want == 2 * 128 * 256 * 64
    assert got["hbm_bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_tally_equals_analyze_on_a_batched_dot():
    a = jax.ShapeDtypeStruct((4, 16, 32), jnp.float32)
    b = jax.ShapeDtypeStruct((4, 32, 8), jnp.float32)
    want = _jax_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), a, b)
    got = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                  _meta(4, 16, 32), _meta(4, 32, 8))
    assert got["flops"] == want == 2 * 4 * 16 * 32 * 8


@pytest.mark.parametrize("layers", [1, 4, 16])
def test_tally_equals_analyze_on_a_loop_of_products(layers):
    def scanned(x, ws):
        return jax.lax.scan(lambda x, w: (x @ w, None), x, ws)[0]

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    want = _jax_flops(scanned, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                      jax.ShapeDtypeStruct((layers, 64, 64), jnp.float32))
    got = analyze(looped, _meta(64, 64), _meta(layers, 64, 64))
    assert got["flops"] == want == 2 * 64 ** 3 * layers


def test_tally_equals_analyze_on_nested_loops():
    def outer(x, ws):
        def body(c, _):
            return jax.lax.scan(lambda x, w: (x @ w, None), c, ws)[0], None
        return jax.lax.scan(body, x, None, length=3)[0]

    def looped(x, ws):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x

    want = _jax_flops(outer, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                      jax.ShapeDtypeStruct((5, 32, 32), jnp.float32))
    got = analyze(looped, _meta(32, 32), _meta(5, 32, 32))
    assert got["flops"] == want == 2 * 32 ** 3 * 5 * 3


def test_tally_keys_and_bytes_bounds():
    m = 512
    got = analyze(lambda a, b: a @ b + 1, _meta(m, m), _meta(m, m))
    for key in ("flops", "hbm_bytes", "hbm_bytes_fused", "hbm_bytes_unfused",
                "collective_bytes", "collective_counts",
                "collective_total_bytes", "n_computations"):
        assert key in got
    want = 3 * m * m * 4
    assert want <= got["hbm_bytes"] <= 3 * want
    assert got["hbm_bytes_fused"] >= got["hbm_bytes"]
    assert got["hbm_bytes_unfused"] >= m * m * 4
    assert got["n_computations"] == 2


# ---------------------------------------------------------- meta branches --
def test_meta_branches_launch_nothing_and_report_their_work():
    reset_launch_counts()
    q, k = _meta(2, 64, 4, 32), _meta(2, 64, 2, 32)
    r = _meta(1, 16, 2, 64)
    u, bt = _meta(1, 16, 8), _meta(1, 16, 4)
    with Tally() as t:
        o = flash_attention(q, k, k, causal=True)
        out, state = rwkv6(r, r, r, r, _meta(2, 64))
        y = selective_scan(u, u, _meta(8, 4), bt, bt)
        mm = modmatmul_batched(_meta(3, 8, 5, dtype=torch.int64),
                               _meta(3, 5, 7, dtype=torch.int64), p=2**31 - 1)
        pe = polyeval(_meta(6, 5, dtype=torch.int64),
                      _meta(5, 9, dtype=torch.int64), p=2**31 - 1)
        rf = ring_fold(_meta(10, dtype=torch.int32), _meta(10, dtype=torch.int32),
                       p=2**31 - 1)
    assert all(n == 0 for n in launch_counts().values()), launch_counts()
    assert o.shape == q.shape and o.device.type == "meta"
    assert out.shape == (1, 16, 2, 64) and out.dtype == torch.float32
    assert state.shape == (1, 2, 64, 64) and y.shape == (1, 16, 8)
    assert mm.shape == (3, 8, 7) and pe.shape == (6, 9) and rf.shape == (10,)
    want = (work.attn_work(q, k, True, 0)[1] + work.wkv_work(1, 16, 2, 4, False)[1]
            + work.scan_work(1, 16, 8, 4, 4)[1]
            + work.mm_work(3, 8, 5, 7, 2**31 - 1)[1]
            + work.pe_work(6, 5, 9, 2**31 - 1)[1] + work.fold_work(10, 4)[1])
    assert t.kernel_flops == want
    assert sorted(t.kernels) == ["flash_attention", "modmatmul_batched",
                                 "polyeval", "ring_fold", "rwkv6",
                                 "selective_scan"]


def test_causal_pairs_closed_form():
    for t in range(0, 9):
        for s in range(0, 9):
            for off in range(-10, 10):
                want = sum(max(0, min(s, off + i + 1)) for i in range(t))
                assert work._pairs(t, s, True, off) == want
    assert work._pairs(5, 7, False, 0) == 35


# ---------------------------------------------------------------- the cells --
@pytest.mark.parametrize("arch", FAMILIES)
def test_build_cell_traces_every_kind(arch):
    cfg = reduced(get_config(arch))
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), devices=["meta"] * 16)
    reset_launch_counts()
    for shape in KINDS:
        cell = build_cell(cfg, shape, mesh)
        assert cell.meta["kind"] == shape.kind
        r = dryrun.run_cell(arch, shape.name, multi_pod=True, out_dir=None,
                            cfg=cfg, shape=shape, mesh=mesh)
        assert r["rows_per_device"] == 2            # 8 rows over pod x data
        assert r["memory"]["argument_size_in_bytes"] > 0
        assert r["hlo_analysis"]["flops"] > 0 or shape.kind == "decode"
        if shape.kind == "train":
            assert r["collectives"]["bytes"]["all-gather"] > 0
            assert r["collectives"]["bytes"]["all-to-all"] > 0
    assert all(n == 0 for n in launch_counts().values())


def test_llama_train_cell_against_jax_on_one_device():
    jcfg = j_reduced(j_get_config("llama3.2-1b"))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = j_build_cell(jcfg, JShape("t", 64, 8, "train"), jmesh)
    with j_sharding_ctx(jmesh, jcell.meta.get("rules")):
        with jmesh:
            compiled = jax.jit(jcell.fn, in_shardings=jcell.in_shardings,
                               donate_argnums=jcell.donate_argnums
                               ).lower(*jcell.args).compile()
    jflops = j_analyze(compiled.as_text())["flops"]
    jargs = compiled.memory_analysis().argument_size_in_bytes
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    r = dryrun.run_cell("llama3.2-1b", "t", multi_pod=False, out_dir=None,
                        cfg=reduced(get_config("llama3.2-1b")),
                        shape=ShapeConfig("t", 64, 8, "train"), mesh=mesh)
    assert r["memory"]["argument_size_in_bytes"] == jargs
    gap = r["hlo_analysis"]["flops"] / jflops - 1
    assert abs(gap) <= 0.10, gap


def test_dryrun_main_runs_a_reduced_cell_and_a_reduced_mpc_cell(tmp_path):
    out = str(tmp_path)
    r = dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                     "--reduced", "--out", out])
    assert r["n_devices"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["rows_per_device"] == 16
    with open(tmp_path / "llama3.2-1b__train_4k__singlepod.json") as f:
        saved = json.load(f)
    for key in ("memory", "hlo_analysis", "collectives", "roofline"):
        assert key in saved
    assert saved["roofline"]["fits_hbm"] is True
    m = dryrun.main(["--mpc", "--m", "64", "--s", "2", "--t", "2", "--z", "2",
                     "--out", out])
    assert m["hlo_analysis"]["kernel_calls"]["modmatmul_batched"] == 16
    assert m["hlo_analysis"]["flops"] > 0
    assert (tmp_path / "age-cmpc__protocol__singlepod.json").exists()

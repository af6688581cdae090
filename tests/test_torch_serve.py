"""The port's serve path: paged KV cache, continuous-batching scheduler and
engine, on the CPU.

Mirrors ``tests/test_paging.py`` for the port: allocator semantics, the
prefill scatter round trip, paged-vs-contiguous token equality at prompt
lengths straddling a block boundary, block recycling, mid-stream
admission, stall recovery, pool exhaustion and the ``max_new`` edges.  The
model is reduced llama3.2-1b with the JAX package's weights carried across
(``params_from_numpy``), and the port's greedy tokens are also held equal
to the JAX engine's.  Token comparisons are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import transformer as j_tr
from repro.serve import Engine as JEngine
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedKVCache
from repro_torch.serve import (
    BlockAllocator,
    Engine,
    OutOfBlocksError,
    ServeScheduler,
)
from repro_torch.serve.paging import NULL_BLOCK, gather_lane, write_prefill


@pytest.fixture(scope="module")
def weights():
    cfg = j_reduced(j_get_config("llama3.2-1b"))
    jp = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _engine(weights, block_size=4):
    cfg, _, tp = weights
    return cfg, Engine(cfg, tp, device="cpu", block_size=block_size)


def _prompt(cfg, t, seed=1, rows=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (rows, t))


def _legacy(eng, cfg, t, seed, max_new):
    return eng._generate_legacy(_prompt(cfg, t, seed=seed), max_new)[0].numpy()


# -------------------------------------------------------------- allocator
def test_allocator_basics_and_null_block():
    al = BlockAllocator(8, 4)
    assert al.blocks_for(1) == 1 and al.blocks_for(4) == 1
    assert al.blocks_for(5) == 2 and al.blocks_for(9) == 3
    assert al.free_blocks() == 7            # block 0 reserved
    got = al.alloc(3)
    assert NULL_BLOCK not in got
    assert al.used_blocks() == 3 and al.free_blocks() == 4
    al.free(got[:2])
    assert al.used_blocks() == 1 and al.free_blocks() == 6
    with pytest.raises(ValueError):
        al.free([got[0]])                   # double free
    with pytest.raises(ValueError):
        al.free([NULL_BLOCK])               # never allocatable
    with pytest.raises(OutOfBlocksError):
        al.alloc(7)
    assert al.stats["allocated"] == 3 and al.stats["freed"] == 2
    assert al.stats["peak_used"] == 3
    with pytest.raises(ValueError):
        BlockAllocator(1, 4)
    with pytest.raises(ValueError):
        BlockAllocator(4, 0)


def test_allocator_recycles_freed_blocks():
    al = BlockAllocator(4, 2)               # 3 usable blocks
    first = al.alloc(3)
    al.free(first)
    second = al.alloc(3)                    # must reuse the same ids
    assert sorted(second) == sorted(first)
    assert al.stats["recycled"] == 3


def test_write_prefill_gather_roundtrip():
    rng = np.random.default_rng(0)
    pool = PagedKVCache.init(6, 4, 2, 8, dtype=torch.float32, leading=(3,),
                             device="cpu")
    k = torch.from_numpy(rng.standard_normal((3, 10, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 10, 2, 8)).astype(np.float32))
    out = write_prefill(pool, k, v, [2, 4, 1], 4)
    assert out is pool                       # written in place
    gk, gv = gather_lane(pool, [2, 4, 1], 10)
    assert torch.equal(gk, k) and torch.equal(gv, v)
    assert bool((pool.k[:, 1, 2:] == 0).all())   # padded tail of the last block
    with pytest.raises(ValueError):
        write_prefill(pool, k, v, [2, 4], 4)


# ---------------------------------------------------- against the JAX engine
def test_generate_equals_jax_engine(weights):
    cfg, jp, tp = weights
    prompt = _prompt(cfg, 6, seed=3, rows=2)
    want = JEngine(cfg, jp, block_size=4).generate(
        jnp.asarray(prompt, jnp.int32), 5)
    got = Engine(cfg, tp, device="cpu", block_size=4).generate(prompt, 5)
    assert got.shape == (2, 5) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------- paged vs contiguous token equality
@pytest.mark.parametrize("t", [3, 4, 5, 9])     # bs-1, bs, bs+1, 2bs+1
def test_paged_equals_legacy_across_block_boundaries(weights, t):
    cfg, eng = _engine(weights, block_size=4)
    prompt = _prompt(cfg, t, seed=t)
    max_new = 6                                   # decode crosses a boundary
    np.testing.assert_array_equal(eng.generate(prompt, max_new).numpy(),
                                  eng._generate_legacy(prompt, max_new).numpy())


def test_paged_batch_matches_legacy_rows(weights):
    cfg, eng = _engine(weights, block_size=4)
    prompt = _prompt(cfg, 6, seed=7, rows=4)
    np.testing.assert_array_equal(eng.generate(prompt, 5).numpy(),
                                  eng._generate_legacy(prompt, 5).numpy())


# -------------------------------------------- recycle / admission / stalls
def test_interleaved_admit_retire_recycles_blocks(weights):
    cfg, eng = _engine(weights, block_size=4)
    sched = eng.make_scheduler(lanes=2, n_blocks=7, max_len=12)
    lengths = [6, 3, 5, 4, 6, 2]
    rids = {sched.submit(_prompt(cfg, t, seed=10 + i), 4): (t, 10 + i)
            for i, t in enumerate(lengths)}
    done = sched.run()
    assert sched.alloc.stats["recycled"] > 0
    assert sched.alloc.used_blocks() == 0
    assert sched.stats["retired"] == len(lengths)
    for rid, (t, seed) in rids.items():
        np.testing.assert_array_equal(done[rid], _legacy(eng, cfg, t, seed, 4))


def test_mid_stream_admission_is_exact(weights):
    cfg, eng = _engine(weights, block_size=4)
    sched = eng.make_scheduler(lanes=3, max_len=16)
    r0 = sched.submit(_prompt(cfg, 5, seed=20), 6)
    r1 = sched.submit(_prompt(cfg, 3, seed=21)[0], 6)    # a [T] prompt
    for _ in range(2):
        sched.step()
    r2 = sched.submit(_prompt(cfg, 7, seed=22), 4)       # late arrival
    done = sched.run()
    assert sched.stats["admitted_inflight"] >= 1
    for rid, (t, seed, mn) in {r0: (5, 20, 6), r1: (3, 21, 6),
                               r2: (7, 22, 4)}.items():
        np.testing.assert_array_equal(done[rid], _legacy(eng, cfg, t, seed, mn))


def test_stalled_lane_recovers_after_retirement(weights):
    cfg, eng = _engine(weights, block_size=2)
    sched = eng.make_scheduler(lanes=2, n_blocks=4, max_len=8)
    ra = sched.submit(_prompt(cfg, 4, seed=30), 3)
    rb = sched.submit(_prompt(cfg, 1, seed=31), 2)
    done = sched.run()
    assert sched.stats["stalls"] >= 1
    for rid, (t, seed, mn) in {ra: (4, 30, 3), rb: (1, 31, 2)}.items():
        np.testing.assert_array_equal(done[rid], _legacy(eng, cfg, t, seed, mn))


def test_pool_exhaustion_raises_when_nothing_can_retire(weights):
    cfg, eng = _engine(weights, block_size=2)
    sched = eng.make_scheduler(lanes=1, n_blocks=2, max_len=6)
    sched.submit(_prompt(cfg, 2, seed=40), 3)
    with pytest.raises(OutOfBlocksError):
        sched.run()


def test_paged_footprint_beats_static_worst_case(weights):
    cfg, eng = _engine(weights, block_size=4)
    max_len = 32
    sched = eng.make_scheduler(lanes=4, max_len=max_len)
    mix = [(30, 41), (4, 42), (6, 43), (3, 44), (5, 45)]
    rids = {sched.submit(_prompt(cfg, t, seed=s), 3): (t, s) for t, s in mix}
    done = sched.run()
    assert sched.alloc.stats["peak_used"] < sched.lanes * sched.alloc.blocks_for(
        max_len)
    for rid, (t, s) in rids.items():
        np.testing.assert_array_equal(done[rid], _legacy(eng, cfg, t, s, 3))


# ----------------------------------------------------------------- edges
def test_generate_edge_cases_max_new_0_and_1(weights):
    cfg, eng = _engine(weights)
    prompt = _prompt(cfg, 4, seed=50, rows=2)
    assert eng.generate(prompt, 0).shape == (2, 0)
    np.testing.assert_array_equal(eng.generate(prompt, 1).numpy(),
                                  eng._generate_legacy(prompt, 1).numpy())
    sched = eng.make_scheduler(lanes=1, max_len=8)
    rid = sched.submit(_prompt(cfg, 3), 0)
    assert sched.finished[rid].shape == (0,) and sched.pending() == 0
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(_prompt(cfg, 8), 2)
    with pytest.raises(ValueError, match="one request"):
        sched.submit(_prompt(cfg, 3, rows=2), 2)


def test_serve_runs_where_it_is_told(weights, monkeypatch):
    cfg, _, tp = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeScheduler(cfg, tp)
    with pytest.raises(ValueError, match="weights are on"):
        Engine(cfg, tp, device="meta")
    assert Engine(cfg, tp, device="cpu").device.type == "cpu"

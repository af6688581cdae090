"""The port's autotuner and worker pools held against the JAX package.

Ranked candidate lists (every field, scores bit-equal), placements, tuned
and re-tuned specs over ``tests/test_autotune.py``'s grids and the pool
rosters of ``tests/test_workers.py``; ``CostModel.from_bench`` weights and
warnings on ``BENCH_PROTOCOL.json``; and the lifted session surfaces
(``MPCSpec.tune``, ``connect(cost=)``, pool specs) exact on the CPU."""
import dataclasses
import itertools
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core.worker_counts import n_age_cmpc
from repro.mpc import autotune as jat
from repro.mpc import workers as jwk
from repro.mpc.api import MPCSpec as JSpec
from repro_torch.mpc import CostModel, MPCSpec, connect, tune
from repro_torch.mpc import autotune as tat
from repro_torch.mpc import workers as twk
from repro_torch.mpc.elastic import ElasticPool
from repro_torch.mpc.engine import MPCEngine

ROOT = Path(__file__).resolve().parents[1]
GRID = [(s, t, z) for s, t, z in itertools.product(range(1, 7), range(2, 7),
                                                    (1, 2, 3, 5, 9, 15))]
COSTS = [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 1.0, 0.0), (1.0, 0.0, 0.0, 0.0),
         (1.0, 0.5, 2.0, 3.0)]


def cand(c):
    """Every field of a Candidate as plain values (the two packages'
    ``Overheads`` are different classes)."""
    return (c.scheme, c.s, c.t, c.lam, c.n_workers, c.m, c.n_blocks,
            c.over_budget, dataclasses.astuple(c.overheads), c.score,
            c.placement)


def spec_fields(s):
    return (s.scheme, s.s, s.t, s.z, s.lam, s.m, s.field.p, s.adversaries,
            None if s.pool is None else s.pool.key, s.placement)


def pools(klass_sets):
    """The same roster in both packages."""
    j = jwk.WorkerPool.of(*[(getattr(jwk, k), n) for k, n in klass_sets])
    t = twk.WorkerPool.of(*[(getattr(twk, k), n) for k, n in klass_sets])
    assert j.key == t.key
    return j, t


def costs(w):
    return jat.CostModel(*w[:3], dispatch=w[3]), CostModel(*w[:3],
                                                          dispatch=w[3])


def test_workers_module_is_a_verbatim_copy():
    orig = (ROOT / "src/repro/mpc/workers.py").read_bytes()
    assert (ROOT / "src/repro_torch/mpc/workers.py").read_bytes() == orig
    assert twk.PHONE.key == jwk.PHONE.key


@pytest.mark.parametrize("s,t,z", GRID)
def test_tune_on_theorem3_grid_equals_jax(s, t, z):
    n = n_age_cmpc(s, t, z)
    j = jat.tune(n, z, (8, 8, 8), s=s, t=t, schemes=("age",))
    r = tune(n, z, (8, 8, 8), s=s, t=t, schemes=("age",))
    assert [cand(c) for c in r.candidates] == [cand(c) for c in j.candidates]
    assert spec_fields(r.spec) == spec_fields(j.spec)
    assert r.spec.n_workers == j.spec.n_workers == n
    if n > 1:
        with pytest.raises(ValueError, match="below the family minimum"):
            tune(n - 1, z, (8, 8, 8), s=s, t=t, schemes=("age",))


@pytest.mark.parametrize("w", COSTS)
@pytest.mark.parametrize("budget,z,shape,kw", [
    (17, 2, (48, 48, 48), {}),
    (60, 2, (64, 64, 64), {}),
    (24, 2, (10, 24, 7), {"batch": 3}),
    (24, 2, (16, 16, 16), {"adversaries": 2}),
    (12, 2, (8, 8, 8), {"adversaries": 2}),
    (10_000, 2, (8, 8, 8), {"s": 2, "t": 2,
                            "schemes": ("entangled", "polydot")}),
    (40, 3, (1, 2048, 4096), {"tile_budget": 8}),
])
def test_search_and_tune_rank_like_jax(w, budget, z, shape, kw):
    jc, tc = costs(w)
    jr = jat.search(budget, z, shape, cost=jc, **kw)
    tr = tat.search(budget, z, shape, cost=tc, **kw)
    assert [cand(c) for c in tr] == [cand(c) for c in jr]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jat.tune(budget, z, shape, cost=jc, **kw)
        r = tune(budget, z, shape, cost=tc, **kw)
    assert spec_fields(r.spec) == spec_fields(j.spec)
    assert (r.tile_budget, r.shape, r.batch) == (j.tile_budget, j.shape,
                                                 j.batch)
    assert dataclasses.astuple(r.predicted) == dataclasses.astuple(j.predicted)


ROSTERS = [
    (("PHONE", 12), ("GATEWAY", 8)),
    (("EDGE_SERVER", 6), ("GATEWAY", 6), ("PHONE", 10)),
    (("GENERIC", 20),),
]


@pytest.mark.parametrize("w", COSTS[:3])
@pytest.mark.parametrize("roster", ROSTERS)
def test_pool_tuning_places_like_jax(roster, w):
    jp, tp = pools(roster)
    jc, tc = costs(w)
    jr = jat.tune(z=2, shape=(32, 32, 32), pool=jp, cost=jc)
    r = tune(z=2, shape=(32, 32, 32), pool=tp, cost=tc)
    assert [cand(c) for c in r.candidates] == [cand(c) for c in jr.candidates]
    assert spec_fields(r.spec) == spec_fields(jr.spec)
    assert r.spec.effective_placement == jr.spec.effective_placement
    assert r.predicted_makespan() == jr.predicted_makespan()
    within = tuple(range(0, len(tp), 2)) + (1,)
    jw = jat.search(z=2, shape=(16, 16, 16), pool=jp, within=within, cost=jc)
    tw = tat.search(z=2, shape=(16, 16, 16), pool=tp, within=within, cost=tc)
    assert [cand(c) for c in tw] == [cand(c) for c in jw]
    for c in tw:
        assert set(c.placement) <= set(within)


@pytest.mark.parametrize("survivors", [20, 17, 12, 8, 6, 2])
@pytest.mark.parametrize("m", [8, 12, 48])
def test_retune_spec_equals_jax(survivors, m):
    for a in (0, 1, 2):
        j = jat.retune_spec(survivors, 2, m=m, adversaries=a)
        r = tat.retune_spec(survivors, 2, m=m, adversaries=a)
        assert (r is None) == (j is None)
        if r is not None:
            assert spec_fields(r) == spec_fields(j)
    jp, tp = pools(ROSTERS[0])
    within = tuple(range(survivors))
    j = jat.retune_spec(z=2, m=m, pool=jp, within=within)
    r = tat.retune_spec(z=2, m=m, pool=tp, within=within)
    assert (r is None) == (j is None)
    if r is not None:
        assert spec_fields(r) == spec_fields(j)


def _fresh_warned(monkeypatch):
    monkeypatch.setattr(jat, "_WARNED_UNKNOWN", set())
    monkeypatch.setattr(tat, "_WARNED_UNKNOWN", set())


def _calibrate(mod, path, **kw):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        cm = mod.CostModel.from_bench(str(path), **kw)
    return cm, [(w.category.__name__, str(w.message)) for w in got]


def test_from_bench_equals_jax_on_the_trajectory(monkeypatch):
    _fresh_warned(monkeypatch)
    path = ROOT / "BENCH_PROTOCOL.json"
    j, jw = _calibrate(jat, path, dispatch=2.0)
    t, tw = _calibrate(tat, path, dispatch=2.0)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert tw == jw
    assert any(w > 0 for w in (t.computation, t.storage, t.communication))


@pytest.mark.parametrize("doc", ["missing", "not json", "{}",
                                 [{"entries": [{"name": "x", "derived": ""}]}],
                                 [{"entries": [
                                     {"name": "a", "fused_us": 5.0,
                                      "derived": "xi=1;sigma=2;zeta=3"},
                                     {"name": "b", "fused_us": 9.0,
                                      "derived": "xi=2;sigma=1;zeta=4"},
                                     {"name": "c", "fused_us": 3.0,
                                      "derived": "wire_zeta=5;wire_us=2"},
                                     {"name": "d", "fused_us": 7.0,
                                      "derived": "xi=3;sigma=3;zeta=1"}]}]])
def test_from_bench_fallbacks_warn_like_jax(tmp_path, monkeypatch, doc):
    _fresh_warned(monkeypatch)
    path = tmp_path / "bench.json"
    if doc != "missing":
        path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    j, jw = _calibrate(jat, path)
    t, tw = _calibrate(tat, path)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert [c for c, _ in tw] == [c for c, _ in jw]
    assert tw == jw


def test_cost_model_helpers_equal_jax():
    jc, tc = costs(COSTS[3])
    assert dataclasses.astuple(tc.with_dispatch_scale(3.0)) == \
        dataclasses.astuple(jc.with_dispatch_scale(3.0))
    mult = {"phone": (2.0, 1.5, 3.0)}
    jp, tp = pools(ROSTERS[0])
    jm, tm = jc.with_class_multipliers(mult), tc.with_class_multipliers(mult)
    assert tm.class_multipliers == jm.class_multipliers
    assert tm.block(16, 2, 2, 2, 17, pool=tp) == jm.block(16, 2, 2, 2, 17,
                                                          pool=jp)
    with pytest.raises(ValueError, match="weight"):
        CostModel(computation=-1.0)
    with pytest.raises(ValueError, match="shape"):
        tune(17, 2, (8, 8))


# ------------------------------------------------- the lifted surfaces
def test_spec_tune_and_pool_specs_match_jax():
    t = MPCSpec.tune(24, 2, (10, 24, 7))
    j = JSpec.tune(24, 2, (10, 24, 7))
    assert spec_fields(t) == spec_fields(j)
    jp, tp = pools(ROSTERS[0])
    pl = tuple(range(19, 2, -1))
    ts = MPCSpec(s=2, t=2, z=2, m=4, pool=tp, placement=pl)
    js = JSpec(s=2, t=2, z=2, m=4, pool=jp, placement=pl)
    assert ts.plan_key() == js.plan_key()
    assert ts.group_key() == js.group_key()
    assert ts.slots_for([19, 3, 0]) == js.slots_for([19, 3, 0])
    assert ts.plan() is MPCSpec(s=2, t=2, z=2, m=4).plan()
    with pytest.raises(ValueError, match="distinct"):
        MPCSpec(s=2, t=2, z=2, pool=tp, placement=(0, 0))
    with pytest.raises(ValueError, match="requires a pool"):
        MPCSpec(s=2, t=2, z=2, placement=(0, 1))


def test_tuned_session_and_cost_block_choice_exact():
    res = tune(24, 2, (10, 24, 7))
    rng = np.random.default_rng(0)
    p = res.spec.field.p
    a = rng.integers(0, p, (10, 24))
    b = rng.integers(0, p, (24, 7))
    want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
    sess = res.connect(device="cpu")
    np.testing.assert_array_equal(sess.matmul(a, b, encoded=True).numpy(),
                                  want)
    cost = connect(MPCSpec(s=2, t=2, z=2), device="cpu", cost=CostModel())
    np.testing.assert_array_equal(cost.matmul(a, b, encoded=True).numpy(),
                                  want)
    jb = connect(MPCSpec(s=2, t=2, z=2), backend="batched", device="cpu",
                 cost=CostModel(0, 0, 1))
    assert jb.backend.engine.cost == CostModel(0, 0, 1)


def test_elastic_retune_equals_jax_and_engine_uses_it():
    from repro.mpc.elastic import ElasticPool as JPool

    for spares, dead in ((3, 12), (1, 10), (2, 1)):
        jp = JPool(s=2, t=2, z=2, m=8, spares=spares)
        tp = ElasticPool(s=2, t=2, z=2, m=8, spares=spares)
        jp.fail(list(range(dead)))
        tp.fail(list(range(dead)))
        np.testing.assert_array_equal(tp._alphas, jp._alphas)
        for name in ("retune", "replan"):
            j, t = getattr(jp, name)(), getattr(tp, name)()
            assert (t is None) == (j is None)
            if t is not None:
                assert t.spec.plan_key() == j.spec.plan_key()
        assert tp.phase3_tolerance() == jp.phase3_tolerance()
        if int(tp.alive.sum()) >= tp.proto.n_workers:
            ji, jw = jp.reconstruction_weights()
            ti, tw = tp.reconstruction_weights()
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tw, jw)
    cm = CostModel(communication=1.0, computation=0.0, storage=0.0)
    eng = MPCEngine(spares=1, max_batch=4, cost=cm, device="cpu")
    spec = MPCSpec(s=2, t=2, z=2, m=8)
    eng.fail(list(range(spec.n_workers - 7)), spec=spec)
    rng = np.random.default_rng(5)
    a = rng.integers(0, spec.field.p, (8, 8))
    b = rng.integers(0, spec.field.p, (8, 8))
    rid = eng.submit(a, b, key=0, spec=spec)
    y = eng.flush()[rid]
    want = np.array((a.astype(object).T @ b.astype(object)) % spec.field.p,
                    np.int64)
    np.testing.assert_array_equal(y.numpy(), want)
    assert eng.stats["retunes"] == 1
    served = eng._replans[spec.plan_key()]
    assert served.spec.plan_key() == \
        jat.retune_spec(8, 2, m=8, cost=jat.CostModel(0, 0, 1)).plan_key()

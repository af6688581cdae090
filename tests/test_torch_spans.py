"""``repro_torch.spans``: off it records nothing and reads no clock; on,
spans nest with parent and root ids, each thread on its own stack, and
the session and the train step emit the spans their layers name, one set
per call or step; the multi-rank tool puts NCCL time down to the
collectives' spans."""
from __future__ import annotations

import collections
import os
import sys
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.models.config import ModelConfig
from repro_torch.mpc import MPCSpec, connect
from repro_torch.parallel import fsdp
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


@pytest.fixture(autouse=True)
def _fresh():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _names(records):
    return collections.Counter(r.name for r in records)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)

    @spans.spanned("f")
    def f(x):
        return x + 1

    assert spans.span("a") is spans.span("b", index=3)
    assert not spans.enabled()
    with spans.span("a", index=1) as sp:
        sp.set(blocks=4)
        assert f(1) == 2
    spans.count("c", 5)
    taken = spans.take()
    assert taken.records == [] and taken.counts == {}


def test_nesting_parents_roots_and_attributes():
    spans.enable()
    assert spans.enabled()
    with spans.span("outer", index=7) as outer:
        outer.set(blocks=3)
        with spans.span("mid"):
            with spans.span("inner"):
                spans.count("work", 2)
        with spans.span("mid"):
            spans.count("work")
    with spans.span("second"):
        pass
    taken = spans.take()
    by = {(r.name, r.start_ns): r for r in taken.records}
    recs = sorted(by.values(), key=lambda r: r.start_ns)
    outer_r, mid1, inner, mid2, second = recs
    assert [r.name for r in recs] == ["outer", "mid", "inner", "mid",
                                      "second"]
    assert outer_r.parent is None and outer_r.root == outer_r.id
    assert outer_r.attrs == {"index": 7, "blocks": 3}
    assert mid1.parent == mid2.parent == outer_r.id
    assert inner.parent == mid1.id
    assert {r.root for r in (mid1, inner, mid2)} == {outer_r.id}
    assert second.parent is None and second.root == second.id
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert outer_r.start_ns <= mid1.start_ns and inner.end_ns <= mid1.end_ns
    assert taken.counts == {"work": 3}
    assert spans.take().records == []


def test_spanned_function_is_traced_once_tracing_is_on():
    @spans.spanned("decorated", kind=1)
    def f(x):
        with spans.span("body"):
            return x * 2

    assert f(2) == 4 and spans.take().records == []
    spans.enable()
    assert f(3) == 6
    recs = {r.name: r for r in spans.take().records}
    assert recs["body"].parent == recs["decorated"].id
    assert recs["decorated"].attrs == {"kind": 1}
    assert f.__name__ == "f"


def test_a_span_on_a_second_thread_while_the_first_is_blocked():
    """A thread opens spans while the caller waits for it (as the autograd
    engine's device thread would in ``torch.autograd.grad``): they start
    a root of their own, and the caller's stack is left as it was."""
    spans.enable()
    seen = {}

    def worker():
        with spans.span("worker.outer"):
            with spans.span("worker.inner"):
                seen["tid"] = threading.get_native_id()

    with spans.span("caller"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        with spans.span("caller.after"):
            pass
    assert not t.is_alive()
    recs = {r.name: r for r in spans.take().records}
    caller, w_outer, w_inner, after = (
        recs[n] for n in ("caller", "worker.outer", "worker.inner",
                          "caller.after"))
    assert w_outer.parent is None and w_outer.root == w_outer.id
    assert w_inner.parent == w_outer.id and w_inner.root == w_outer.id
    assert after.parent == caller.id and after.root == caller.id
    assert w_outer.thread == seen["tid"] != caller.thread == after.thread
    assert caller.start_ns <= w_outer.start_ns <= w_outer.end_ns \
        <= caller.end_ns


def test_many_threads_keep_their_own_stacks():
    """More threads than cores, a short switch interval: every outer span
    is a root, every inner span's parent is its own thread's outer span,
    whose root it shares, and no count is lost."""
    threads, rounds = 16, 300
    spans.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with spans.span("outer"):
                    with spans.span("inner"):
                        spans.count("n")

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    taken = spans.take()
    assert taken.counts == {"n": threads * rounds}
    by_id = {r.id: r for r in taken.records}
    assert _names(taken.records) == {"outer": threads * rounds,
                                     "inner": threads * rounds}
    for r in taken.records:
        if r.name == "inner":
            parent = by_id[r.parent]
            assert parent.name == "outer" and parent.thread == r.thread
            assert r.root == parent.id
        else:
            assert r.parent is None and r.root == r.id


@pytest.mark.parametrize("shape,blocks", [((12, 20, 9), 12), ((8, 8, 8), 1)])
def test_one_session_call_emits_its_spans(shape, blocks):
    r, k, c = shape
    sess = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu", key=3)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(r, k, generator=gen)
    b = torch.randn(k, c, generator=gen)
    spans.enable()
    got = sess.matmul(a, b)
    taken = spans.take()
    assert got.shape == (r, c)
    names = _names(taken.records)
    assert names == {"mpc.call": 1, "mpc.request": 1, "mpc.build": 1,
                     **{n: blocks for n in ("mpc.block", "mpc.encode",
                                            "mpc.worker_compute",
                                            "mpc.exchange", "mpc.decode")}}
    call = next(r for r in taken.records if r.name == "mpc.call")
    assert call.attrs == {"blocks": blocks, "m": 8}
    assert {r.root for r in taken.records} == {call.id}
    by_id = {r.id: r for r in taken.records}
    for r in taken.records:
        if r.name in ("mpc.encode", "mpc.worker_compute", "mpc.exchange",
                      "mpc.decode"):
            assert by_id[r.parent].name == "mpc.block"
        elif r.name != "mpc.call":
            assert r.parent == call.id
    assert sorted(r.attrs["index"] for r in taken.records
                  if r.name == "mpc.block") == list(range(blocks))


def test_spans_leave_the_session_result_as_it_was():
    a = torch.randn(12, 20, generator=torch.Generator().manual_seed(1))
    b = torch.randn(20, 9, generator=torch.Generator().manual_seed(2))
    off = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu", key=5)
    on = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu", key=5)
    y_off = off.matmul(a, b)
    spans.enable()
    y_on = on.matmul(a, b)
    assert torch.equal(y_off, y_on)


def test_a_flush_is_one_call_over_its_requests():
    sess = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu", key=4)
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(3))
    spans.enable()
    sess.submit(a, a)
    sess.submit(a, a.T)
    out = sess.flush()
    taken = spans.take()
    assert len(out) == 2
    names = _names(taken.records)
    assert names["mpc.call"] == 1 and names["mpc.request"] == 2
    assert names["mpc.build"] == 2 and names["mpc.block"] == 2
    call = next(r for r in taken.records if r.name == "mpc.call")
    assert call.attrs == {"blocks": 2, "m": 8}


def _tiny_step(microbatches):
    mc = ModelConfig(name="tiny", family="ssm", n_layers=2, d_model=64,
                     n_heads=0, n_kv_heads=0, d_ff=128, vocab=256,
                     dtype="float32", remat=True, norm_eps=1e-5,
                     subquadratic=True)
    tc = TrainConfig(microbatches=microbatches, seq_chunk=16)
    params, opt = init_train_state(mc, tc, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, 256, (4, 32), generator=gen)
             for k in ("tokens", "targets")}
    return make_train_step(mc, tc), params, opt, batch


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_emits_its_phases(microbatches):
    step, params, opt, batch = _tiny_step(microbatches)
    spans.enable()
    step(params, opt, batch)
    taken = spans.take()
    mb = microbatches
    assert _names(taken.records) == {
        "train.step": 1, "train.forward": mb, "train.backward": mb,
        "train.optimizer": 1, "model.layers": mb, "model.loss": mb,
        "optim.clip_norm": 1, "optim.adamw": 1}
    by_id = {r.id: r for r in taken.records}
    root = next(r for r in taken.records if r.name == "train.step")
    assert {r.root for r in taken.records} == {root.id}
    parent = {"train.forward": "train.step", "train.backward": "train.step",
              "train.optimizer": "train.step", "model.layers":
              "train.forward", "model.loss": "train.forward",
              "optim.clip_norm": "train.optimizer",
              "optim.adamw": "train.optimizer"}
    for r in taken.records:
        if r.name in parent:
            assert by_id[r.parent].name == parent[r.name]
    for phase in ("train.forward", "train.backward"):
        assert sorted(r.attrs["micro"] for r in taken.records
                      if r.name == phase) == list(range(mb))


def test_spans_leave_the_train_step_as_it_was():
    step, p_off, o_off, batch = _tiny_step(2)
    _, p_on, o_on, _ = _tiny_step(2)
    _, _, m_off = step(p_off, o_off, batch)
    spans.enable()
    _, _, m_on = step(p_on, o_on, batch)
    assert torch.equal(m_off["loss"], m_on["loss"])
    for (n, a), (_, b) in zip(p_off.named_parameters(),
                              p_on.named_parameters(), strict=True):
        assert torch.equal(a, b), n


def test_a_collective_opens_its_span_and_is_counted():
    fsdp.reset_stats()
    assert fsdp.STATS == {"calls": {}}
    spans.enable()
    out = fsdp._collective("all_gather", lambda x, y=0: x + y, 2, y=3)
    assert out == 5
    assert fsdp.STATS["calls"] == {"all_gather": 1}
    assert [r.name for r in spans.take().records] == ["fsdp.all_gather"]


def test_nccl_time_goes_to_the_collective_span_that_launched_it():
    """``tools/multicard_train.py``: each NCCL kernel by its launch's
    runtime call, on the spans' clock, to the ``fsdp.<kind>`` span open
    then; launches outside every such span, or with no runtime call, go
    to ``""``."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import multicard_train as mc

    def rec(i, name, a, b):
        return spans.Record(i, None, i, name, a, b, 1, {})

    records = [rec(1, "train.step", 0, 1_000),
               rec(2, "fsdp.all_gather", 100, 200),
               rec(3, "fsdp.all_to_all", 300, 400),
               rec(4, "fsdp.all_gather", 500, 600)]
    off = 10_000
    kernels = [(7, 2_000_000), (8, 3_000_000), (9, 1_000_000),
               (10, 4_000_000), (11, 500_000)]
    launch = {7: off + 150, 8: off + 399, 9: off + 550, 10: off + 450}
    assert mc.nccl_by_span(kernels, launch, records, off) == {
        "fsdp.all_gather": 3.0, "fsdp.all_to_all": 3.0, "": 4.5}
    assert mc.nccl_by_span([], launch, records, off) == {}

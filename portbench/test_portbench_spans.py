"""The program's spans on the profile's clock: the offset from the marker
launches, device time put down to the span that launched it, idle time cut
at the spans' edges, gaps named by span, and the readers that would report
them; on a CPU profile, the converted spans fall inside the traced
window."""
from __future__ import annotations

import types

import pytest
import torch

from portbench.harness import spans as hs
from portbench.harness import trace as tr_mod
from portbench.harness.trace import Trace
from repro_torch import spans as program
from repro_torch.spans import Record


def rec(id, name, start, end, parent=None, root=None, thread=1):
    return Record(id, parent, id if root is None else root, name, start, end,
                  thread, {})


# spans on the perf clock; the profile reads perf + OFFSET
OFFSET = 1_000_000
SPANS = [rec(1, "A", 0, 100), rec(2, "C", 20, 60, parent=1, root=1),
         rec(3, "B", 100, 200)]


def at_of(device, spans=SPANS, window=(OFFSET, OFFSET + 300)):
    return hs.Attribution(window, device, spans, OFFSET)


def test_a_gap_is_split_at_the_spans_edges():
    # busy at both edges; idle from 10 to 290: 10..20 in A, 20..60 in C
    # (inside A), 60..100 in A, 100..200 in B, 200..290 in none
    at = at_of([(OFFSET, OFFSET + 10, "k0", None),
                (OFFSET + 290, OFFSET + 300, "k1", None)])
    assert at.gaps == [(OFFSET + 10, OFFSET + 290)]
    assert at.idle_s("C") == pytest.approx(40e-9)
    assert at.idle_s("A") == pytest.approx(90e-9)      # C's included
    assert at.self_idle_s("A") == pytest.approx(50e-9)
    assert at.idle_s("B") == pytest.approx(100e-9)
    assert at.idle_s(None) == pytest.approx(90e-9)
    assert (at.idle_s("A") + at.idle_s("B") + at.idle_s(None)) == \
        pytest.approx(280e-9)


def test_device_time_goes_to_the_span_that_launched_it():
    # launched in C at 30, runs while B is open; launched in B, runs after
    at = at_of([(OFFSET + 120, OFFSET + 150, "k_c", OFFSET + 30),
                (OFFSET + 210, OFFSET + 250, "k_b", OFFSET + 150),
                (OFFSET + 260, OFFSET + 270, "k_none", OFFSET + 250),
                (OFFSET + 280, OFFSET + 285, "k_lost", None)])
    assert at.device_s("C") == pytest.approx(30e-9)
    assert at.device_s("A") == pytest.approx(30e-9)
    assert at.device_s("B") == pytest.approx(40e-9)
    assert at.unlaunched_ns == 5
    assert at.launches(r"^k_") == {"A/C": 1, "B": 1, "": 1}
    assert at.path(2) == ("A", "C")


def test_a_span_on_another_thread_is_innermost_while_open():
    spans = SPANS + [rec(4, "W", 40, 50, parent=2, root=1, thread=2)]
    at = at_of([(OFFSET + 100, OFFSET + 110, "k", OFFSET + 45),
                (OFFSET + 120, OFFSET + 130, "k2", OFFSET + 55)], spans)
    assert at.launches("k") == {"A/C/W": 1, "A/C": 1}
    assert at.device_s("A") == pytest.approx(20e-9)


def test_gaps_are_named_by_the_span_covering_most_of_them():
    device = [(OFFSET, OFFSET + 10, "k0", None),
              (OFFSET + 130, OFFSET + 140, "k1", None),
              (OFFSET + 290, OFFSET + 300, "k2", None)]
    host = [(OFFSET + 120, OFFSET + 121, "cudaLaunchKernel"),
            (OFFSET + 280, OFFSET + 281, "cudaLaunchKernel")]
    trace = Trace((OFFSET, OFFSET + 300), [d[:3] for d in device], host)
    at = at_of(device)
    # 10..130: A alone 50, C 40, B 30; 140..290: B 60, no span 90
    assert at.named_gaps(trace, 10) == [
        ["before cudaLaunchKernel", 150e-9],
        ["A: before cudaLaunchKernel", 120e-9]]
    assert [s for _, s in at.named_gaps(trace, 10)] == \
        [s for _, s in trace.idle_gaps(10)]


def test_the_marker_launches_bound_the_offset():
    off = 5_000
    marks = [(100, 120), (1_000, 1_006)]
    device = [(off + 130, off + 131, "mark", 7),
              (off + 500, off + 600, "k", 8),
              (off + 1_010, off + 1_011, "mark", 9)]
    launch = {7: (off + 104, off + 110), 9: (off + 1_002, off + 1_003),
              8: (off + 400, off + 401)}
    # [r1 - t1, r0 - t0] over both marks: [off - 10, off + 4] and
    # [off - 3, off + 2]
    bounds = hs.clock_bounds(marks, device, launch)
    assert bounds == (off - 3, off + 2)
    assert hs.clock_offset(bounds, off + 1) == off + 1
    assert hs.clock_offset(bounds, off + 50) is None      # clocks disagree
    assert hs.clock_offset(bounds, off - 4) is None
    assert hs.clock_offset(None, off + 50) == off + 50
    assert hs.clock_bounds(marks, device, {7: launch[7]}) is None
    assert hs.clock_bounds([(100, 101), (1_000, 1_001)], device,
                           {7: (off + 104, off + 105),
                            9: (off + 2_000, off + 2_001)}) is None
    assert hs.clock_bounds([], device, launch) is None


class _Event:
    """A kineto event as :func:`hs._events` reads it."""

    def __init__(self, name, start, dur, corr, cuda):
        self._v = (name, start, dur, corr, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"

    def is_user_annotation(self):
        return False


@pytest.mark.parametrize("realtime,attributed", [(5_001, True),
                                                 (5_050, False)])
def test_no_attribution_where_the_marks_exclude_the_offset(realtime,
                                                           attributed):
    """The marker launches' runtime calls bound the offset to
    ``[5_000 - 3, 5_000 + 2]``: inside, the spans go on the profile's
    clock at ``realtime``; outside, no guess is made."""
    off = 5_000
    events = [_Event("mark", off + 130, 1, 7, True),
              _Event("k", off + 500, 100, 8, True),
              _Event("mark", off + 1_010, 1, 9, True),
              _Event("cudaLaunchKernel", off + 104, 6, 7, False),
              _Event("cudaLaunchKernel", off + 400, 1, 8, False),
              _Event("cudaLaunchKernel", off + 1_002, 1, 9, False)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    rec_ = types.SimpleNamespace(
        prof=prof, spans=[rec(1, "S", 390, 410)], realtime_ns=realtime,
        marks=[(100, 120), (1_000, 1_006)],
        trace=types.SimpleNamespace(w0=off + 130, w1=off + 1_011))
    at = hs.attribution(rec_)
    if not attributed:
        assert at is None
        return
    assert at.offset == realtime and at.bounds == (off - 3, off + 2)
    assert at.launches("^k$") == {"S": 1}


def test_readers_on_synthetic_contexts():
    at = at_of([(OFFSET, OFFSET + 10, "k0", OFFSET + 5),
                (OFFSET + 290, OFFSET + 300, "k1", OFFSET + 150)])
    ctx = types.SimpleNamespace(items=2, spans=at)
    assert hs.span_device_ms(ctx, "A") == pytest.approx(1e3 * 10e-9 / 2)
    assert hs.span_device_ms(ctx, "B") == pytest.approx(1e3 * 10e-9 / 2)
    assert hs.span_device_ms(ctx, "C") == 0.0
    assert hs.span_idle_pct(ctx, "B") == pytest.approx(100 * 100 / 300)
    assert hs.span_device_ms(ctx, "missing") is None
    assert hs.span_idle_pct(ctx, "missing") is None
    bare = types.SimpleNamespace(items=2, trace=None)
    assert hs.span_device_ms(bare, "A") is None
    assert hs.span_idle_pct(bare, "A") is None
    none = types.SimpleNamespace(items=2, spans=None)
    assert hs.span_device_ms(none, "A") is None


def test_untraced_stretch_has_no_attribution():
    with hs.traced(False) as rec_:
        with program.span("x"):
            pass
    assert hs.attribution(rec_) is None
    program.take()


def test_spans_of_a_cpu_profile_fall_inside_its_window():
    from repro_torch.mpc import MPCSpec, connect

    sess = connect(MPCSpec(s=2, t=2, z=2, m=8), device="cpu", key=1)
    a = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    plain = tr_mod._mark
    with hs.traced(True) as rec_:
        sess.matmul(a, a.T)
    assert tr_mod._mark is plain and not program._on
    assert rec_.marks == []            # no card: no marker launches
    names = {r.name for r in rec_.spans}
    assert {"mpc.call", "mpc.block", "mpc.encode"} <= names
    at = hs.attribution(rec_)
    assert at.offset == rec_.realtime_ns and at.bounds is None
    window = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in rec_.prof.profiler.kineto_results.events()
              if e.name() == tr_mod.WINDOW]
    assert len(window) == 1
    w0, w1 = window[0]
    for r in rec_.spans:
        assert w0 <= r.start_ns + at.offset <= r.end_ns + at.offset <= w1
    # with no device activity the window is idle throughout, under the call
    assert at.idle_s("mpc.call") > 0


def test_the_report_on_a_tiny_head(checkout):
    from portbench import spans_report

    line = spans_report.run(checkout, "tiny-head.r8", 2 ** 31 + 9, 0.3,
                            "trace", torch.device("cpu"), 0.0)
    assert line["correct"] and line["mode"] == "trace"
    rep = line["spans"]
    per = rep["spans_per_item"]
    assert {n: per[n] for n in ("mpc.call", "mpc.request", "mpc.build")} \
        == {"mpc.call": 1, "mpc.request": 1, "mpc.build": 1}
    assert per["mpc.block"] == per["mpc.encode"] > 1
    assert rep["cover"]["whole_ms"] == 0.0          # no card: no device ops
    assert rep["offset_bounds_ns"] is None          # no marker launches
    assert not program._on


@pytest.mark.parametrize("workload", ["tiny-head.r8", "tiny-rwkv.t64"])
def test_the_report_with_spans_on_through_a_run(checkout, workload):
    """``--mode window`` on the CPU: an untraced run with every call's or
    step's spans recorded, set-up and checks included."""
    from portbench import spans_report

    line = spans_report.run(checkout, workload, 2 ** 31 + 10, 0.3, "window",
                            torch.device("cpu"), 0.0)
    assert line["correct"] and line["mode"] == "window"
    got = line["spans_recorded"]
    if workload == "tiny-head.r8":
        assert got["mpc.call"] == got["mpc.request"] == got["mpc.build"] \
            >= line["attempted"]
    else:
        steps = got["train.step"]
        assert steps >= line["attempted"] + 1
        assert got["train.forward"] == got["train.backward"] == 2 * steps
        assert got["train.optimizer"] == steps
    assert not program._on

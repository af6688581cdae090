"""The program's spans on the profile's clock, and the device time and idle
time of a traced stretch put down to them.

:func:`traced` is :func:`portbench.harness.trace.traced` with the
program's spans (``repro_torch.spans``) on for the traced stretch alone;
the :class:`~portbench.harness.trace.Recorder` it hands back also carries
the spans' records (``spans``), the ``time.perf_counter_ns`` brackets of
the two marker launches at the stretch's edges (``marks``) and the
offset of ``time.time_ns`` from ``time.perf_counter_ns`` when it opened
(``realtime_ns``).  :func:`attribution` reduces all of it:

* the clock: the program's spans read ``perf_counter_ns``
  (``CLOCK_MONOTONIC``), the profile's events Unix-epoch ns, so the
  offset between the two is ``realtime_ns``.  Each marker launch's
  ``cudaLaunchKernel`` call (found by its kernel's correlation id) ran
  inside its bracket, which bounds the offset: where ``realtime_ns``
  lies outside both marks' bounds the clocks disagree, and there is no
  attribution;
* device time: each device operation goes, through its correlation id,
  to the runtime call that launched it and then to the innermost span, on
  any thread, open at that call: time is put down by when a kernel was
  launched, not when it ran;
* idle time: each stretch of the window with no device operation is cut
  at the spans' edges, and each piece goes to the innermost span open
  over it (or to none).

A span's totals count what its descendants hold (``train.forward`` holds
``model.layers``'s).  Nothing here changes what :class:`Trace` reads.
"""
from __future__ import annotations

import bisect
import contextlib
import heapq
import re
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from . import trace as _trace


def realtime_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    five brackets."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        r = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, r - (p0 + p1) // 2)
    return best[1]


@contextlib.contextmanager
def traced(enabled: bool):
    """:func:`trace.traced`, with the program's spans on inside the traced
    stretch and handed back on the recorder."""
    if not enabled:
        with _trace.traced(False) as rec:
            yield rec
        return
    from repro_torch import spans as program

    marks: List[Tuple[int, int]] = []
    plain = _trace._mark

    def stamped(torch) -> None:
        t0 = time.perf_counter_ns()
        plain(torch)
        marks.append((t0, time.perf_counter_ns()))

    _trace._mark = stamped
    try:
        with _trace.traced(True) as rec:
            rec.realtime_ns = realtime_offset_ns()
            program.take()
            program.enable()
            try:
                yield rec
            finally:
                program.disable()
                rec.spans = program.take().records
    finally:
        _trace._mark = plain
    rec.marks = marks


def _events(prof):
    """``(device ops, runtime calls by correlation id)`` of a profile: the
    device operations as :func:`trace.reduce` keeps them, each with its
    correlation id, and each host call's ``(start, end)``."""
    device, launch = [], {}
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), int(e.start_ns())
        corr = int(e.correlation_id())
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation() and not name.startswith(
                    "portbench."):
                device.append((s, s + int(e.duration_ns()), name, corr))
        elif corr:
            launch.setdefault(corr, (s, s + int(e.duration_ns())))
    return device, launch


def clock_bounds(marks, device, launch) -> Optional[Tuple[int, int]]:
    """``(lo, hi)``: the offsets (ns, ``profile = perf + offset``) that
    put each marker launch's runtime call (the first and last device
    operations') inside its ``perf_counter_ns`` bracket; None where a
    mark's launch is not in the profile or the brackets disagree."""
    if not marks or not device:
        return None
    ops = sorted(device)
    edges = [ops[0], max(ops, key=lambda o: o[1])][:len(marks)]
    lo = hi = None
    for (t0, t1), op in zip(marks, edges, strict=True):
        if op[3] not in launch:
            return None
        # the runtime call [r0, r1] ran inside [t0, t1]
        r0, r1 = launch[op[3]]
        lo = r1 - t1 if lo is None else max(lo, r1 - t1)
        hi = r0 - t0 if hi is None else min(hi, r0 - t0)
    return (lo, hi) if lo <= hi else None


def clock_offset(bounds, realtime_ns: int) -> Optional[int]:
    """The offset: ``time.time_ns() - time.perf_counter_ns()`` (the
    profile's clock is Unix-epoch ns) where it lies inside the marks'
    ``bounds`` or there are none; None where it lies outside them, as a
    guess inside them (their middle leans late: a bracket holds the
    allocation and dispatch before its launch) misplaces kernels
    launched microseconds from a span's edge."""
    if bounds is None or bounds[0] <= realtime_ns <= bounds[1]:
        return realtime_ns
    return None


class Attribution:
    """Device and idle time of one traced stretch by the program's spans.

    ``window``: the traced window (profile ns); ``device``: ``(start, end,
    name, launch)`` device operations, ``launch`` the profile time of the
    runtime call that launched each (None where the profile has none);
    ``spans``: the program's records; ``offset``: profile ns minus
    ``perf_counter_ns``; ``bounds``: the offsets the marker launches
    allow, if any."""

    def __init__(self, window: Tuple[int, int], device: list, spans: list,
                 offset: int, bounds: Optional[Tuple[int, int]] = None):
        self.w0, self.w1 = window
        self.offset, self.bounds = offset, bounds
        self.device = sorted((max(a, self.w0), min(b, self.w1), n, at)
                             for a, b, n, at in device
                             if b > self.w0 and a < self.w1 and b > a)
        self.spans = {r.id: r for r in spans}
        self._build_timeline()
        self.device_by: Counter = Counter()
        self.ops_by: Dict[Optional[int], list] = {}
        self.unlaunched_ns = 0
        for a, b, n, at in self.device:
            if at is None:
                self.unlaunched_ns += b - a
                continue
            sid = self.innermost(at)
            self.device_by[sid] += b - a
            self.ops_by.setdefault(sid, []).append(n)
        self.gaps = self._gaps()
        self.idle_by: Counter = Counter()
        for a, b in self.gaps:
            for sid, ns in self._pieces(a, b):
                self.idle_by[sid] += ns
        self._paths: Dict[int, Tuple[str, ...]] = {}

    # ------------------------------------------------------------ timeline
    def _build_timeline(self) -> None:
        """Piecewise-constant innermost span over the profile clock:
        ``_seg_t[i]`` starts a stretch whose innermost open span is
        ``_seg_id[i]`` (None: none open).  Innermost is the latest-opened;
        a span covers ``[start, end)``."""
        edges = []
        for r in self.spans.values():
            a, b = r.start_ns + self.offset, r.end_ns + self.offset
            edges.append((a, 1, r.id))
            edges.append((b, 0, r.id))          # ends before starts
        edges.sort()
        heap: list = []
        ended: set = set()
        self._seg_t: List[int] = []
        self._seg_id: List[Optional[int]] = []
        i = 0
        while i < len(edges):
            t = edges[i][0]
            while i < len(edges) and edges[i][0] == t:
                _, opening, sid = edges[i]
                if opening:
                    r = self.spans[sid]
                    heapq.heappush(heap, (-r.start_ns, -sid))
                else:
                    ended.add(sid)
                i += 1
            while heap and -heap[0][1] in ended:
                heapq.heappop(heap)
            top = -heap[0][1] if heap else None
            if not self._seg_id or self._seg_id[-1] != top:
                self._seg_t.append(t)
                self._seg_id.append(top)

    def innermost(self, t: int) -> Optional[int]:
        """The innermost span open at profile time ``t``, or None."""
        i = bisect.bisect_right(self._seg_t, t) - 1
        return self._seg_id[i] if i >= 0 else None

    def _pieces(self, a: int, b: int):
        """``(span id or None, ns)`` of ``[a, b)`` cut at the spans'
        edges."""
        i = max(bisect.bisect_right(self._seg_t, a) - 1, 0)
        at = a
        if not self._seg_t or a < self._seg_t[0]:
            end = b if not self._seg_t else min(b, self._seg_t[0])
            yield None, end - a
            at = end
        while at < b and i < len(self._seg_t):
            end = self._seg_t[i + 1] if i + 1 < len(self._seg_t) else b
            end = min(end, b)
            if end > at:
                yield self._seg_id[i], end - at
                at = end
            i += 1

    def _gaps(self) -> List[Tuple[int, int]]:
        """The window's stretches with no device operation, in order."""
        gaps, at = [], self.w0
        busy: List[List[int]] = []
        for a, b, _, _ in self.device:
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.w1 > at:
            gaps.append((at, self.w1))
        return gaps

    # --------------------------------------------------------------- reads
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def path(self, sid: Optional[int]) -> Tuple[str, ...]:
        """The names from the outermost span down to ``sid`` (parents
        missing from the records end the walk)."""
        if sid is None:
            return ()
        if sid not in self._paths:
            r = self.spans[sid]
            up = self.path(r.parent) if r.parent in self.spans else ()
            self._paths[sid] = up + (r.name,)
        return self._paths[sid]

    def has(self, name: str) -> bool:
        return any(r.name == name for r in self.spans.values())

    def device_s(self, name: str) -> float:
        """Device seconds launched while a span ``name`` was open (any
        span inside it included)."""
        return sum(ns for sid, ns in self.device_by.items()
                   if name in self.path(sid)) / 1e9

    def idle_s(self, name: Optional[str]) -> float:
        """Idle seconds of the window while a span ``name`` was open (None:
        while none was)."""
        if name is None:
            return self.idle_by.get(None, 0) / 1e9
        return sum(ns for sid, ns in self.idle_by.items()
                   if name in self.path(sid)) / 1e9

    def self_idle_s(self, name: str) -> float:
        """Idle seconds while a span ``name`` was the innermost open."""
        return sum(ns for sid, ns in self.idle_by.items()
                   if sid is not None and self.spans[sid].name == name) / 1e9

    def launches(self, pattern: str) -> Counter:
        """Device operations whose name matches ``pattern``, counted by the
        path of the span that launched them ("" for none)."""
        rx = re.compile(pattern)
        out: Counter = Counter()
        for sid, names in self.ops_by.items():
            key = "/".join(self.path(sid))
            for n in names:
                if rx.search(n):
                    out[key] += 1
        return out

    def named_gaps(self, tr, k: int = 10) -> list:
        """``tr.idle_gaps(k)`` (``tr``: the same profile's :class:`Trace`),
        each name led by the path of the innermost span that holds the
        largest part of its gap, unless no span holds more of it than is
        outside every span."""
        order = sorted(self.gaps, key=lambda g: g[0] - g[1])
        out = []
        for (name, s), (a, b) in zip(tr.idle_gaps(k), order, strict=False):
            cover: Counter = Counter()
            for sid, ns in self._pieces(a, b):
                cover[sid] += ns
            top = max(cover, key=lambda sid: (cover[sid], sid is None))
            if top is not None:
                name = "/".join(self.path(top)) + ": " + name
            out.append([name, s])
        return out


def attribution(rec) -> Optional[Attribution]:
    """The recorder's profile and spans as an :class:`Attribution`; None
    where the stretch was not traced, held no span, or the marker
    launches put the profile's clock elsewhere than ``realtime_ns``."""
    prof, spans = rec.prof, getattr(rec, "spans", None)
    if prof is None or spans is None:
        return None
    device, launch = _events(prof)
    tr = rec.trace
    bounds = clock_bounds(getattr(rec, "marks", []), device, launch)
    offset = clock_offset(bounds, rec.realtime_ns)
    if offset is None:
        return None
    ops = [(a, b, n, launch[c][0] if c in launch else None)
           for a, b, n, c in device]
    return Attribution((tr.w0, tr.w1), ops, spans, offset, bounds)


# ------------------------------------------------- per-layer metric readers
# The benchmark's LayerContext carries no attribution yet, so these read
# only what ``portbench/spans_report.py`` hands them.
def span_device_ms(ctx, name: str) -> Optional[float]:
    """Device ms a traced item launched inside the span ``name``: None
    without an attribution (``ctx.spans``) or where no such span ran."""
    at = getattr(ctx, "spans", None)
    if at is None or not ctx.items or not at.has(name):
        return None
    return 1e3 * at.device_s(name) / ctx.items


def span_idle_pct(ctx, name: str) -> Optional[float]:
    """Share of the traced window in which the device is idle while the
    host is inside the span ``name``; None as :func:`span_device_ms`."""
    at = getattr(ctx, "spans", None)
    if at is None or at.window_s <= 0 or not at.has(name):
        return None
    return 100.0 * at.idle_s(name) / at.window_s

"""The device trace of a stretch of the window, and what it reduces to.

``traced(enabled)`` wraps the traced stretch in ``torch.profiler``.  On a
card it records CUDA activity alone (kernels, copies, and the CUDA runtime
calls the host makes), so that the profiler does not record every host
operation and stretch the steps it measures; a one-element marker kernel
opens and closes the stretch, so the device's own events span the traced
window, and the stretch ends in a synchronisation.  Without a card (the
tests) it records host activity inside a ``record_function`` range named
``WINDOW``, which then bounds the window.  :class:`Trace` holds the device
intervals and the host intervals of that window and answers the metric
readers: the union of device activity (``busy_s``), device time by kernel
name, the top device operations and the longest idle gaps, each with what
the host was doing.
"""
from __future__ import annotations

import contextlib
import re
from typing import List, Optional, Tuple

WINDOW = "portbench.window"

Interval = Tuple[int, int, str]      # start ns, end ns, name


class Trace:
    """Device and host intervals (ns, one clock) inside the traced window."""

    def __init__(self, window: Tuple[int, int], device: List[Interval],
                 host: List[Interval]):
        self.w0, self.w1 = window
        self.device = sorted((max(a, self.w0), min(b, self.w1), n)
                             for a, b, n in device
                             if b > self.w0 and a < self.w1 and b > a)
        self.host = host

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (overlaps counted
        once)."""
        return sum(b - a for a, b in self._union()) / 1e9

    def device_s(self, pattern: str) -> float:
        """Summed device seconds of the operations whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time, by name."""
        tot: dict = {}
        for a, b, n in self.device:
            key = _short(n)
            tot[key] = tot.get(key, 0) + (b - a)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in best]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches with no device operation, each named
        by the innermost host operation that spans its middle, or else by
        the first one that starts inside it (``before <op>``: the host was
        in Python until that op)."""
        gaps, at = [], self.w0
        for a, b in self._union():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.w1 > at:
            gaps.append((at, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [(s, e, n) for s, e, n in self.host if n != WINDOW]
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            inner = [(s, n) for s, e, n in host if s <= mid <= e]
            later = [(s, n) for s, e, n in host if a <= s <= b]
            name = ("(no host op)" if not (inner or later) else
                    _short(max(inner)[1]) if inner else
                    "before " + _short(min(later)[1]))
            out.append([name, (b - a) / 1e9])
        return out


def _short(name: str) -> str:
    """A kernel's name without namespaces' decorations, template arguments
    and parameters."""
    bare = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", bare, maxsplit=1)[0][:80] or name[:80]


class Recorder:
    """What ``traced`` hands back.  ``trace`` reduces the profile on first
    read, so that a run can leave the reduction until its window has
    closed; None with tracing off."""

    prof = None
    _trace: Optional[Trace] = None

    @property
    def trace(self) -> Optional[Trace]:
        if self._trace is None and self.prof is not None:
            self._trace = reduce(self.prof)
        return self._trace


def _mark(torch) -> None:
    """A one-element kernel: an edge of the traced window on the device."""
    torch.zeros(1, device="cuda")


@contextlib.contextmanager
def traced(enabled: bool):
    rec = Recorder()
    if not enabled:
        yield rec
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA if card else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            if card:
                _mark(torch)
            yield rec
            if card:
                _mark(torch)
                torch.cuda.synchronize()
    rec.prof = prof


def reduce(prof) -> Trace:
    """The profile's kineto events as a :class:`Trace`: the window is the
    span of the device's events where there are any, else the ``WINDOW``
    range."""
    rows = [(e.name(), int(e.start_ns()), int(e.duration_ns()),
             str(e.device_type()).endswith("CUDA"),
             bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]
    device = [(s, s + d, n) for n, s, d, dev, ann in rows
              if dev and not ann and not n.startswith("portbench.")]
    host = [(s, s + d, n) for n, s, d, dev, _ in rows if not dev]
    if device:
        window = (min(a for a, _, _ in device), max(b for _, b, _ in device))
    else:
        ranges = [(s, s + d) for n, s, d, dev, _ in rows
                  if n == WINDOW and not dev]
        if not ranges:
            raise RuntimeError("the traced window's range is missing from "
                               "the profile")
        window = ranges[0]
    return Trace(window, device, host)

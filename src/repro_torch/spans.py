"""Spans and counters inside the program, kept in memory.

A span records where a layer's work starts and ends on the host::

    from repro_torch import spans

    with spans.span("mpc.block", index=i):
        ...

    @spans.spanned("mpc.encode")
    def encode(...):
        ...

Each record holds the span's name, its start and end from
``time.perf_counter_ns()``, its own id, the id of the span open around it
(its parent, the span that caused it), the id of the outermost one (its
root: the spans of one session call or one training step share it), the
OS thread id and the small integer attributes given at the open or set on
the open span (``with span(...) as sp: sp.set(blocks=n)``).  ``count(name,
n)`` adds to a counter at the same boundaries.

Tracing is off until a caller turns it on (:func:`enable`); :func:`take`
hands back the records and counters kept since the last take and clears
them.  Off, :func:`span` returns one shared null context after one test of
a module flag: it reads no clock and builds no record, and ``spanned``
functions call straight through.  A span never touches a tensor, so it
neither waits for the device nor allocates on it: where the host opens
and closes it is all it says; the profiler's clock puts the device's work
beside it.

Threads: each thread keeps its own stack of open spans, so a span opened
on a thread with none open (a worker thread, the autograd engine's device
thread) starts a root of its own; threads never share a parent.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

_on = False
_records: List[tuple] = []                 # Record fields, closed spans
_counts: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_count_lock = threading.Lock()
_local = threading.local()                 # this thread's stack and OS id


class Record(NamedTuple):
    """One closed span (times in ``perf_counter_ns``)."""

    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int
    thread: int          # threading.get_native_id(), the OS thread id
    attrs: dict


class _Null:
    """What :func:`span` hands back with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        self.stack = stack
        self.start = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        _records.append((self.id, self.parent, self.root, self.name,
                         self.start, end, _local.thread, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager around one layer's work: a new span with tracing
    on, the shared null context with it off."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def spanned(name: str, **attrs):
    """Decorator: each call of the function runs inside ``span(name,
    **attrs)``.  Tracing is tested at each call, so a function decorated
    when its module is imported is traced once tracing is turned on."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not _on:
                return fn(*args, **kw)
            with _Span(name, dict(attrs)):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (with tracing on)."""
    if _on:
        with _count_lock:
            _counts[name] += n


def enabled() -> bool:
    """Whether spans are being recorded (for work done only to describe a
    span, such as its attributes)."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    global _on
    _on = False


class Taken(NamedTuple):
    records: List[Record]
    counts: Dict[str, int]


def take() -> Taken:
    """The records closed and the counts added since the last take, in the
    order they closed; both are cleared."""
    global _records, _counts
    with _count_lock:
        records, counts = _records, _counts
        _records, _counts = [], collections.Counter()
    return Taken([Record._make(r) for r in records], dict(counts))

"""Deterministic discrete-event core for the fleet simulator.

A deliberately small calendar: events are ``(time, seq)``-ordered on a
heap, handlers are registered per event kind, and the loop runs until
the calendar drains.  Ties break by insertion sequence, so two replays
of the same trace are *bit-identical* — determinism is the property the
divergence gate (DESIGN.md §11) rests on, and it is enforced here, not
hoped for: no wall clock, no global RNG, no dict-order dependence.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One calendar entry; orders by ``(at_us, seq)``.

    ``seq`` is the queue's insertion counter — simultaneous events fire
    in the order they were scheduled, never in heap-internal order.
    ``kind`` routes to the handler; ``payload`` is handler-owned.
    """

    at_us: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """A seeded-sequence min-heap of :class:`Event`."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, at_us: float, kind: str, payload: Any = None) -> Event:
        if at_us < 0:
            raise ValueError(f"event time must be >= 0, got {at_us}")
        ev = Event(at_us=float(at_us), seq=self._seq, kind=kind,
                   payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class Simulator:
    """The event loop: ``on(kind, handler)``, ``schedule``, ``run``.

    Handlers receive ``(sim, event)`` and may schedule further events;
    time only moves forward (scheduling into the past raises).  ``run``
    returns the clock at the last handled event — the replay's makespan
    when the last event completes the last request.
    """

    def __init__(self):
        self.queue = EventQueue()
        self.now = 0.0
        self._handlers: Dict[str, Callable[["Simulator", Event], None]] = {}

    def on(self, kind: str,
           handler: Callable[["Simulator", Event], None]) -> None:
        if kind in self._handlers:
            raise ValueError(f"handler for {kind!r} already registered")
        self._handlers[kind] = handler

    def schedule(self, at_us: float, kind: str,
                 payload: Any = None) -> Event:
        if at_us < self.now:
            raise ValueError(
                f"cannot schedule {kind!r} at {at_us} < now {self.now}")
        return self.queue.push(at_us, kind, payload)

    def run(self, *, max_events: int = 10_000_000) -> float:
        """Drain the calendar; returns the final clock (µs)."""
        handled = 0
        while self.queue:
            ev = self.queue.pop()
            self.now = ev.at_us
            try:
                handler = self._handlers[ev.kind]
            except KeyError:
                raise ValueError(f"no handler for event kind {ev.kind!r}"
                                 ) from None
            handler(self, ev)
            handled += 1
            if handled >= max_events:
                raise RuntimeError(
                    f"simulation exceeded {max_events} events — "
                    f"likely a handler rescheduling itself forever")
        return self.now

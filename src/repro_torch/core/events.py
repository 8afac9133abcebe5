"""Discrete-event engine.

A single binary heap of ``(time, priority, seq)`` keys. Priorities order
simultaneous events so that capacity freed at time t is visible to an
arrival at the same t:

    EXEC_DONE < COLD_DONE < TIMER < NODE_ARRIVAL < REROUTE < CHURN
              < RETRY < ARRIVAL

``NODE_ARRIVAL`` is the deferred-delivery leg of a routed request
(dynamic cluster routing under per-node network delay: the router
decides at the raw ARRIVAL, the node sees the request ``delay`` later);
it sorts before raw ARRIVALs so an in-flight request reaches its node
before the router decides the next one at the same instant.
``REROUTE`` carries a request orphaned by a node failure back through
the router, and ``CHURN`` is a node availability toggle (NODE_DOWN /
NODE_UP, see docs/cluster.md); orphans re-route before any same-time
churn toggle or fresh arrival, and churn resolves before the router
sees a same-time arrival. ``RETRY`` re-injects a failed/timed-out
request after its backoff delay (`repro_torch.core.resilience` plans
the retries); it resolves after churn (a same-time toggle settles availability first)
but before fresh arrivals (the retried request is older). ``seq``
breaks remaining ties FIFO, keeping runs fully deterministic.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Optional


class EventKind(IntEnum):
    EXEC_DONE = 0     # an instance finished a request     -> FRP hook
    COLD_DONE = 1     # a (re)initialisation finished      -> instance ready
    TIMER = 2         # policy-armed timer (OpenWhisk V2 threshold)
    NODE_ARRIVAL = 3  # a routed request reaches its node  -> FCP hook
    REROUTE = 4       # an orphaned request re-enters the router
    CHURN = 5         # a node goes down / comes back up
    RETRY = 6         # a failed request re-enters after backoff
    ARRIVAL = 7       # a request arrives (router decides) -> FCP hook


@dataclass(order=True)
class Event:
    time: float
    kind: int
    seq: int
    payload: Any = field(compare=False, default=None)
    cancelled: bool = field(compare=False, default=False)


class EventQueue:
    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: EventKind, payload: Any = None) -> Event:
        ev = Event(time, int(kind), next(self._seq), payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Optional[Event]:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if not ev.cancelled:
                return ev
        return None

    def __len__(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)

    def __bool__(self) -> bool:
        return any(not e.cancelled for e in self._heap)

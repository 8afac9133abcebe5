"""Baseline schedulers of paper §VI-A.

* **OpenWhisk** — central FIFO queue in arrival order; scales up an
  instance when an arriving request finds no idle instance (evicting the
  least-recently-used idle instance when at capacity).
* **SFF** — identical to OpenWhisk except the central queue is ordered by
  the function's *running-mean execution time* (shortest function first).
* **FaasCache** [Fuerst & Sharma, ASPLOS'21] — OpenWhisk-style scheduling
  with GREEDY-DUAL keep-alive: eviction victim = idle instance with the
  lowest priority ``clock + freq * cold_start``; the global clock is bumped
  to the evicted priority.
* **OpenWhisk V2** — per-function queues; a new instance is initialised
  only after the queue-head request has waited longer than a fixed
  threshold (100 ms).

All four reuse the slot primitives of :class:`~repro_torch.core.server.EdgeServer`
so their cold-start / eviction accounting is identical to ESFF's.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Tuple

from repro_torch.core.events import EventKind
from repro_torch.core.policy import POLICIES, Policy
from repro_torch.core.request import Request
from repro_torch.core.server import Instance, InstanceState


class CentralQueuePolicy(Policy):
    """Shared machinery for OpenWhisk / SFF / FaasCache.

    The central queue is stored as one FIFO deque per function plus a
    global count; "head of queue" scans the per-function heads with the
    policy's ordering key (O(|F|), exact even when SFF's running means
    drift over time).
    """

    def bind(self, server, estimator) -> None:
        super().bind(server, estimator)
        self.fifo: Dict[int, Deque[Request]] = {
            f.fn_id: deque() for f in self.functions
        }
        self.waiting = 0

    # -- ordering ---------------------------------------------------------
    def _key(self, req: Request) -> Tuple:
        return (req.arrival, req.req_id)

    def _head(self) -> Optional[Request]:
        best, best_key = None, None
        for q in self.fifo.values():
            if q:
                k = self._key(q[0])
                if best_key is None or k < best_key:
                    best, best_key = q[0], k
        return best

    def _pop(self, req: Request) -> None:
        q = self.fifo[req.fn_id]
        assert q and q[0] is req
        q.popleft()
        self.waiting -= 1

    def _push(self, req: Request) -> None:
        self.fifo[req.fn_id].append(req)
        self.waiting += 1

    # -- eviction choice (overridden by FaasCache) -------------------------
    def _victim(self) -> Optional[Instance]:
        idle = self.server.idle_instances()
        if not idle:
            return None
        return min(idle, key=lambda i: (i.last_used, i.inst_id))  # LRU

    def _note_evict(self, inst: Instance) -> None:
        pass

    def _note_use(self, inst: Instance) -> None:
        pass

    def _evict_and_start(self, fn_id: int, t: float) -> bool:
        victim = self._victim()
        if victim is None:
            return False
        self._note_evict(victim)
        self.server.start_cold(fn_id, t, evict=victim)
        return True

    # -- hooks --------------------------------------------------------------
    def on_arrival(self, req: Request, t: float) -> None:
        srv = self.server
        idle = srv.idle_of(req.fn_id)
        if idle is not None:
            self._note_use(idle)
            srv.dispatch(idle, req, t)
            return
        self._push(req)
        # Scale up: no idle instance for this request.
        if srv.has_free_slot():
            srv.start_cold(req.fn_id, t)
        else:
            self._evict_and_start(req.fn_id, t)

    def on_cold_done(self, inst: Instance, t: float) -> None:
        # The instance was provisioned *for* its function's waiting
        # requests; serve the earliest of them before falling back to the
        # central-queue discipline.
        self.server.make_idle(inst)
        q = self.fifo[inst.fn_id]
        if q:
            req = q[0]
            self._pop(req)
            self._note_use(inst)
            self.server.dispatch(inst, req, t)
            return
        self._serve_or_replace(inst, t)

    def on_exec_done(self, inst: Instance, req: Request, t: float) -> None:
        self.server.make_idle(inst)
        self._serve_or_replace(inst, t)

    # Central-queue discipline: a warm instance first drains its own
    # function's earliest waiting request (container reuse — real
    # OpenWhisk behaviour, and exactly Fig. 1(a)/(b)'s schedule); only an
    # instance with no matching work retargets to the queue-head function
    # (evict + cold start), at most one warming replica at a time.
    # ``strict=True`` (the *_hol ablation policies) removes warm reuse:
    # the slot serves the global head or retargets — full head-of-line
    # blocking, which collapses under bursts (EXPERIMENTS.md §Repro).
    strict = False

    def _serve_or_replace(self, inst: Instance, t: float) -> None:
        srv = self.server
        head = self._head()
        if head is None:
            return
        if not self.strict and self.fifo[inst.fn_id]:
            head = self.fifo[inst.fn_id][0]     # first matching request
        if head.fn_id == inst.fn_id:
            self._pop(head)
            self._note_use(inst)
            srv.dispatch(inst, head, t)
            return
        # Retarget this idle slot to the head's function, capped at the
        # smaller of (one warming replica, its waiting count).
        warming = sum(
            1 for i in srv.by_fn[head.fn_id]
            if srv.instances[i].state == InstanceState.COLD
        )
        cap = len(self.fifo[head.fn_id]) if self.strict else 1
        if warming < cap:
            self._note_evict(inst)
            srv.start_cold(head.fn_id, t, evict=inst)


@POLICIES.register("openwhisk")
class OpenWhisk(CentralQueuePolicy):
    name = "openwhisk"


@POLICIES.register("sff")
class SFF(CentralQueuePolicy):
    """Shortest Function First: arrival order -> mean-execution-time order."""

    name = "sff"

    def _key(self, req: Request):
        return (self.est.mean(req.fn_id), req.arrival, req.req_id)


@POLICIES.register("faascache")
class FaasCache(CentralQueuePolicy):
    """GREEDY-DUAL keep-alive eviction (size=1, cost=cold start)."""

    name = "faascache"

    def bind(self, server, estimator) -> None:
        super().bind(server, estimator)
        self.clock = 0.0

    def _note_use(self, inst: Instance) -> None:
        inst.priority = (
            self.clock
            + (inst.freq + 1) * self.functions[inst.fn_id].cold_start
        )

    def _note_evict(self, inst: Instance) -> None:
        self.clock = max(self.clock, inst.priority)

    def _victim(self) -> Optional[Instance]:
        idle = self.server.idle_instances()
        if not idle:
            return None
        return min(idle, key=lambda i: (i.priority, i.inst_id))


@POLICIES.register("openwhisk_hol")
class OpenWhiskHOL(OpenWhisk):
    """Ablation: fully head-of-line-blocking OpenWhisk (no warm reuse of
    non-head requests) — the literal reading of 'processes requests in
    ascending arrival order'. Collapses under bursts; kept to quantify
    how much of ESFF's win is blocking-removal vs cold-start awareness."""

    name = "openwhisk_hol"
    strict = True


@POLICIES.register("faascache_hol")
class FaasCacheHOL(FaasCache):
    """Ablation: head-of-line FaasCache (see openwhisk_hol)."""

    name = "faascache_hol"
    strict = True


@POLICIES.register("openwhisk_v2")
class OpenWhiskV2(Policy):
    """Per-function queues + 100 ms head-wait threshold before scale-up."""

    name = "openwhisk_v2"
    threshold = 0.1  # seconds (paper: 100 ms)

    def bind(self, server, estimator) -> None:
        super().bind(server, estimator)
        self._init_fn_queues()

    def _arm(self, req: Request, t: float) -> None:
        self.server.events.push(t + self.threshold, EventKind.TIMER, req)

    def on_arrival(self, req: Request, t: float) -> None:
        srv = self.server
        idle = srv.idle_of(req.fn_id)
        if not self.queues[req.fn_id] and idle is not None:
            srv.dispatch(idle, req, t)
            return
        self.queues[req.fn_id].append(req)
        self._arm(req, t)

    def on_timer(self, req: Request, t: float) -> None:
        if req.start >= 0:   # already running / done
            return
        q = self.queues[req.fn_id]
        if not q or q[0] is not req:
            return           # no longer the head; its own timer will fire
        srv = self.server
        warming = any(
            srv.instances[i].state == InstanceState.COLD
            for i in srv.by_fn[req.fn_id]
        )
        if not warming:
            if srv.has_free_slot():
                srv.start_cold(req.fn_id, t)
            else:
                idle = srv.idle_instances()
                if idle:
                    victim = min(idle, key=lambda i: (i.last_used, i.inst_id))
                    srv.start_cold(req.fn_id, t, evict=victim)
                else:
                    self._arm(req, t)   # still blocked; retry
                    return
        else:
            self._arm(req, t)

    def on_cold_done(self, inst: Instance, t: float) -> None:
        self.server.make_idle(inst)
        q = self.queues[inst.fn_id]
        if q:
            self.server.dispatch(inst, q.popleft(), t)

    def on_exec_done(self, inst: Instance, req: Request, t: float) -> None:
        # V2 keeps draining its own queue (the behaviour Fig. 1(b) criticises).
        self.server.make_idle(inst)
        q = self.queues[inst.fn_id]
        if q:
            self.server.dispatch(inst, q.popleft(), t)

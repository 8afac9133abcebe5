"""Edge server model (paper §III): at most C co-resident function instances.

An :class:`Instance` occupies one slot from the moment its (cold start or
eviction+cold-start) transition begins until it is evicted. Replacing an
idle instance of f_{j'} by f_j therefore keeps the slot count at C and
costs ``t_{j'}^v + t_j^l`` before the new instance becomes ready — exactly
the paper's cost model.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Set

from repro_torch.core.events import EventKind, EventQueue
from repro_torch.core.request import FunctionProfile, Request


class InstanceState(IntEnum):
    COLD = 0   # transitioning: eviction of predecessor + cold start
    IDLE = 1   # state(k) = 1 in the paper
    BUSY = 2   # state(k) = 0 in the paper


@dataclass
class Instance:
    inst_id: int
    fn_id: int
    state: InstanceState
    ready_at: float = 0.0
    current: Optional[Request] = None
    # bookkeeping for keep-alive style policies (FaasCache)
    freq: int = 0
    priority: float = 0.0
    last_used: float = 0.0


class ExecTimeEstimator:
    """Per-function running mean of *observed* execution times (§V).

    The scheduler can only learn execution times from completed requests.
    Before the first completion of f_j we fall back to the global running
    mean, and before any completion at all to ``prior`` seconds.
    """

    def __init__(self, n_functions: int, prior: float = 0.1,
                 oracle: Optional[List[float]] = None):
        self.n = [0] * n_functions
        self.sum = [0.0] * n_functions
        self.gn = 0
        self.gsum = 0.0
        self.prior = prior
        self.oracle = oracle

    def observe(self, fn_id: int, exec_time: float) -> None:
        self.n[fn_id] += 1
        self.sum[fn_id] += exec_time
        self.gn += 1
        self.gsum += exec_time

    def mean(self, fn_id: int) -> float:
        if self.oracle is not None:
            return max(self.oracle[fn_id], 1e-9)
        if self.n[fn_id] > 0:
            return max(self.sum[fn_id] / self.n[fn_id], 1e-9)
        if self.gn > 0:
            return max(self.gsum / self.gn, 1e-9)
        return self.prior


@dataclass
class ServerStats:
    cold_starts: int = 0
    cold_time: float = 0.0
    evictions: int = 0
    evict_time: float = 0.0
    busy_time: float = 0.0


class EdgeServer:
    """Slot/instance bookkeeping shared by every scheduling policy."""

    def __init__(self, functions: List[FunctionProfile], capacity: int,
                 events: EventQueue):
        self.functions = functions
        self.capacity = capacity
        self.events = events
        self.instances: Dict[int, Instance] = {}
        self.by_fn: Dict[int, Set[int]] = {f.fn_id: set() for f in functions}
        self.stats = ServerStats()
        self._ids = itertools.count()

    # ------------------------------------------------------------ queries
    def total_instances(self) -> int:
        return len(self.instances)

    def has_free_slot(self) -> bool:
        return len(self.instances) < self.capacity

    def k_count(self, fn_id: int) -> int:
        """|K^j| — instances currently assigned to f_j (any state)."""
        return len(self.by_fn[fn_id])

    def idle_of(self, fn_id: int) -> Optional[Instance]:
        # sorted => earliest-created first: deterministic across runs and
        # engines (set iteration order would leak hash-table layout)
        for iid in sorted(self.by_fn[fn_id]):
            inst = self.instances[iid]
            if inst.state == InstanceState.IDLE:
                return inst
        return None

    def idle_instances(self) -> List[Instance]:
        return [i for i in self.instances.values()
                if i.state == InstanceState.IDLE]

    def has_idle(self, fn_id: int) -> bool:
        return self.idle_of(fn_id) is not None

    # --------------------------------------------------------- primitives
    def dispatch(self, inst: Instance, req: Request, t: float) -> None:
        """Run ``req`` on an *idle* instance of its function."""
        assert inst.state == InstanceState.IDLE, inst
        assert inst.fn_id == req.fn_id
        inst.state = InstanceState.BUSY
        inst.current = req
        inst.freq += 1
        inst.last_used = t
        req.start = t
        req.completion = t + req.exec_time
        self.stats.busy_time += req.exec_time
        self.events.push(req.completion, EventKind.EXEC_DONE, inst)

    def start_cold(self, fn_id: int, t: float,
                   evict: Optional[Instance] = None) -> Instance:
        """Begin initialising a new instance of f_j, optionally by evicting
        an *idle* instance first (cost t_v of the evicted function)."""
        delay = self.functions[fn_id].cold_start
        if evict is not None:
            assert evict.state == InstanceState.IDLE, evict
            delay += self.functions[evict.fn_id].evict
            self.stats.evictions += 1
            self.stats.evict_time += self.functions[evict.fn_id].evict
            self._remove(evict)
        if len(self.instances) >= self.capacity:
            raise RuntimeError("start_cold would exceed capacity")
        inst = Instance(next(self._ids), fn_id, InstanceState.COLD,
                        ready_at=t + delay)
        self.instances[inst.inst_id] = inst
        self.by_fn[fn_id].add(inst.inst_id)
        self.stats.cold_starts += 1
        self.stats.cold_time += self.functions[fn_id].cold_start
        self.events.push(inst.ready_at, EventKind.COLD_DONE, inst)
        return inst

    def make_idle(self, inst: Instance) -> None:
        inst.state = InstanceState.IDLE
        inst.current = None

    def _remove(self, inst: Instance) -> None:
        del self.instances[inst.inst_id]
        self.by_fn[inst.fn_id].discard(inst.inst_id)

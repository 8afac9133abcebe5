"""`ClusterSpec`: one declared multi-node edge cluster topology
(counterpart of `repro.cluster.spec`).

The paper schedules functions on a *single* resource-limited edge
server; real edge deployments are K small nodes behind a request
router. A `ClusterSpec` declares that topology (node count, per-node
slot capacities, the router and its knobs) as one frozen value that
rides the `repro_torch.api.ExperimentSpec` ``cluster`` axis.

The port runs the static routers (``hash``, ``round_robin``,
``weighted_random``) on the static tier (`repro_torch.cluster.static`)
and the dynamic ones (``jsq2``, ``cold_aware``, ``slo_aware``, the
circuit breaker ``breaker`` and any registered `DynamicRouter`) on the
K-node event loop (`repro_torch.cluster.engine`).

Robustness axis: a spec may declare per-node *churn* (availability
windows: explicit ``(down_at, up_at)`` lists or a `PeriodicChurn`
generator, the LEO-satellite case) and a time-varying per-node network
delay (`DelaySchedule`). Both run on the dynamic tier only; the static
tier rejects them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

# the engine's "never" time (`repro_torch.core.engine.BIG`)
BIG = 1e30


def _bad(field: str, msg: str):
    raise ValueError(f"ClusterSpec.{field}: {msg}")


@dataclass(frozen=True)
class PeriodicChurn:
    """Periodic availability generator for one node (LEO-satellite
    style): the node repeats a cycle of length ``period`` seconds and
    is **up** for the first ``duty`` fraction of each cycle; the whole
    pattern is shifted by ``phase`` seconds (up intervals are
    ``[phase + n*period, phase + n*period + duty*period)``).
    ``duty=1.0`` means always up (no churn events are generated)."""

    period: float
    duty: float = 0.5
    phase: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "period", float(self.period))
        object.__setattr__(self, "duty", float(self.duty))
        object.__setattr__(self, "phase", float(self.phase))

    def validate(self, field: str = "churn"):
        if not math.isfinite(self.period) or self.period <= 0:
            _bad(field, f"PeriodicChurn.period must be finite and > 0, "
                        f"got {self.period}")
        if math.isnan(self.duty) or not 0.0 < self.duty <= 1.0:
            _bad(field, f"PeriodicChurn.duty must be in (0, 1], got "
                        f"{self.duty}")
        if not math.isfinite(self.phase):
            _bad(field, f"PeriodicChurn.phase must be finite, got "
                        f"{self.phase}")

    def toggles(self, horizon: float) -> Tuple[float, ...]:
        """Alternating (down, up, down, ...) toggle times in
        ``[0, horizon]``; a node that would end the horizon down gets
        its natural next up appended so parked work always recovers."""
        if self.duty >= 1.0:
            return ()
        P, d, ph = self.period, self.duty, self.phase
        # generate (time, is_up) edges from one full cycle before t=0
        n = math.floor((0.0 - ph) / P) - 1
        edges = []
        while True:
            up_at = ph + n * P
            edges.append((up_at, True))
            edges.append((up_at + d * P, False))
            if up_at > horizon:
                break
            n += 1
        # state at t=0: the last edge at time <= 0 decides (the
        # generator always emits one)
        up0 = True
        for t, is_up in edges:
            if t <= 0.0:
                up0 = is_up
        toggles = [] if up0 else [0.0]
        for t, is_up in edges:
            if t <= 0.0 or t > horizon:
                continue
            want_down = len(toggles) % 2 == 0   # next toggle goes down
            if is_up != (not want_down):
                continue                        # duplicate of t=0 state
            toggles.append(t)
        if len(toggles) % 2 == 1:               # ends down: append the
            last = toggles[-1]                  # next up after `last`
            k = math.ceil((last - ph) / P - 1e-12)
            up_next = ph + k * P
            while up_next <= last:
                up_next += P
            toggles.append(up_next)
        return tuple(toggles)


@dataclass(frozen=True)
class DelaySchedule:
    """Piecewise-constant (optionally periodic) per-node network
    delay: ``values[i]`` applies on ``[times[i], times[i+1])``;
    ``times[0]`` must be 0. With ``period > 0`` the schedule wraps
    (lookup at ``t % period``), the LEO orbital-latency case."""

    times: Tuple[float, ...]
    values: Tuple[float, ...]
    period: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "times",
                           tuple(float(t) for t in self.times))
        object.__setattr__(self, "values",
                           tuple(float(v) for v in self.values))
        object.__setattr__(self, "period", float(self.period))

    def validate(self, field: str = "delay_schedule"):
        if not self.times or len(self.times) != len(self.values):
            _bad(field, f"DelaySchedule needs matching non-empty "
                        f"times/values, got {len(self.times)} times "
                        f"and {len(self.values)} values")
        if self.times[0] != 0.0:
            _bad(field, f"DelaySchedule.times must start at 0, got "
                        f"{self.times[0]}")
        for a, b in zip(self.times, self.times[1:]):
            if not a < b:
                _bad(field, f"DelaySchedule.times must be strictly "
                            f"increasing, got {self.times}")
        if any(not math.isfinite(t) for t in self.times):
            _bad(field, f"DelaySchedule.times must be finite, got "
                        f"{self.times}")
        for v in self.values:
            if math.isnan(v) or v < 0 or math.isinf(v):
                _bad(field, f"DelaySchedule values must be finite and "
                            f">= 0, got {self.values}")
        if math.isnan(self.period) or self.period < 0:
            _bad(field, f"DelaySchedule.period must be >= 0, got "
                        f"{self.period}")
        if self.period > 0 and self.times[-1] >= self.period:
            _bad(field, f"DelaySchedule.times must stay below the "
                        f"period ({self.period}), got {self.times}")

    def at(self, t: float) -> float:
        """Delay in effect at time ``t`` (plain-Python mirror of the
        engine's rail lookup)."""
        tt = t % self.period if self.period > 0 else t
        i = 0
        for j, s in enumerate(self.times):
            if tt >= s:
                i = j
        return self.values[i]


ChurnEntry = Union[None, PeriodicChurn, Tuple[Tuple[float, float], ...]]


@dataclass(frozen=True)
class ClusterSpec:
    """K heterogeneous edge nodes behind one request router.

    ``n_nodes``       K, how many nodes the cluster has.
    ``router``        a name registered in `repro_torch.cluster.routers`.
    ``node_capacity`` per-node slot counts (length K); when set it
                      overrides the spec's capacity axis (which must then
                      have exactly one entry, kept as the row label);
                      ``None`` gives every node the capacity-axis value.
    ``net_delay``     per-node network delay (seconds; scalar or
                      length-K tuple) added to each routed request's
                      arrival before it reaches its node; its response
                      is measured from that node-local arrival.
    ``seed``          the hash seed of the randomised routers (JSQ's
                      draws too).
    ``weights``       relative node weights for ``weighted_random``
                      (length K; uniform by default).
    ``churn``         per-node availability: ``None`` (always up), a
                      `PeriodicChurn` (broadcast), or a length-K tuple
                      whose entries are ``None``, a `PeriodicChurn`, or
                      an explicit tuple of ``(down_at, up_at)`` windows.
                      Dynamic tier only: a down node's requests are
                      drained and re-routed, and under churn a response
                      is measured from the raw arrival.
    ``delay_schedule``time-varying override of ``net_delay``: a
                      `DelaySchedule` (broadcast) or a length-K tuple of
                      ``DelaySchedule | None`` (``None`` keeps that
                      node's constant delay). Dynamic tier only.
    """

    n_nodes: int = 2
    router: str = "hash"
    node_capacity: Optional[Tuple[int, ...]] = None
    net_delay: Union[float, Tuple[float, ...]] = 0.0
    seed: int = 0
    weights: Optional[Tuple[float, ...]] = None
    churn: Union[None, PeriodicChurn, Tuple[ChurnEntry, ...]] = None
    delay_schedule: Union[None, DelaySchedule,
                          Tuple[Optional[DelaySchedule], ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "n_nodes", int(self.n_nodes))
        if self.node_capacity is not None:
            object.__setattr__(
                self, "node_capacity",
                tuple(int(c) for c in self.node_capacity))
        if not isinstance(self.net_delay, (int, float)):
            object.__setattr__(
                self, "net_delay",
                tuple(float(d) for d in self.net_delay))
        else:
            object.__setattr__(self, "net_delay", float(self.net_delay))
        if self.weights is not None:
            object.__setattr__(
                self, "weights", tuple(float(w) for w in self.weights))
        if self.churn is not None:
            if isinstance(self.churn, PeriodicChurn):
                object.__setattr__(
                    self, "churn", (self.churn,) * self.n_nodes)
            else:
                object.__setattr__(
                    self, "churn",
                    tuple(self._norm_churn_entry(e) for e in self.churn))
        if isinstance(self.delay_schedule, DelaySchedule):
            object.__setattr__(
                self, "delay_schedule",
                (self.delay_schedule,) * self.n_nodes)
        elif self.delay_schedule is not None:
            object.__setattr__(
                self, "delay_schedule", tuple(self.delay_schedule))

    @staticmethod
    def _norm_churn_entry(e) -> ChurnEntry:
        if e is None or isinstance(e, PeriodicChurn):
            return e
        return tuple((float(d), float(u)) for d, u in e)

    # ---------------------------------------------------------- helpers
    @property
    def label(self) -> str:
        """Coordinate label on the ResultSet cluster axis, router first,
        as the JAX package labels it: ``jsq2:K4``, ``hash:K2x8,4``,
        ``round_robin:K2+d``, ``slo_aware:K4+dvar+churn``."""
        tag = f"{self.router}:K{self.n_nodes}"
        if self.node_capacity is not None:
            caps = set(self.node_capacity)
            tag += (f"x{self.node_capacity[0]}" if len(caps) == 1
                    else "x" + ",".join(map(str, self.node_capacity)))
        if self.delay_ops() is not None:
            tag += "+dvar"
        elif any(self.delays()):
            tag += "+d"
        if self.has_churn():
            tag += "+churn"
        return tag

    def delays(self) -> Tuple[float, ...]:
        """Per-node constant network delays, expanded to length K. A
        node whose `DelaySchedule` has one step folds into this tuple;
        a time-varying node keeps its base constant here and is
        overridden by `delay_ops`."""
        if isinstance(self.net_delay, tuple):
            base = list(self.net_delay)
        else:
            base = [self.net_delay] * self.n_nodes
        if self.delay_schedule is not None:
            for k, ds in enumerate(self.delay_schedule):
                if ds is not None and len(ds.values) == 1 \
                        and k < len(base):
                    base[k] = ds.values[0]
        return tuple(base)

    def delay_ops(self):
        """The time-varying delay schedules as padded numpy operands
        ``(dtimes (K, D), dvals (K, D), dper (K,))`` f64, or ``None``
        when every node is constant. A node without a (multi-step)
        schedule gets a one-step row holding its constant delay; step
        times pad with `BIG`, values with the last step's."""
        if self.delay_schedule is None:
            return None
        if not any(ds is not None and len(ds.values) > 1
                   for ds in self.delay_schedule):
            return None
        consts = self.delays()
        D = max(len(ds.times) if ds is not None else 1
                for ds in self.delay_schedule)
        dtimes = np.full((self.n_nodes, D), BIG, dtype=np.float64)
        dvals = np.zeros((self.n_nodes, D), dtype=np.float64)
        dper = np.zeros((self.n_nodes,), dtype=np.float64)
        for k in range(self.n_nodes):
            ds = self.delay_schedule[k]
            if ds is None or len(ds.values) == 1:
                dtimes[k, 0] = 0.0
                dvals[k, :] = consts[k]
                continue
            n = len(ds.times)
            dtimes[k, :n] = ds.times
            dvals[k, :n] = ds.values
            dvals[k, n:] = ds.values[-1]
            dper[k] = ds.period
        return dtimes, dvals, dper

    def has_churn(self) -> bool:
        """Whether any node declares a non-trivial availability pattern
        (a `PeriodicChurn` with ``duty < 1`` or a non-empty window
        list). Independent of the horizon: the runner still runs the
        plain loop when the toggles are empty over the trace."""
        if self.churn is None:
            return False
        for e in self.churn:
            if e is None:
                continue
            if isinstance(e, PeriodicChurn):
                if e.duty < 1.0:
                    return True
            elif len(e) > 0:
                return True
        return False

    def churn_toggles(self, horizon: float) -> Tuple[Tuple[float, ...],
                                                     ...]:
        """Per-node alternating toggle times (even index: the node goes
        DOWN, odd: it comes back UP; every node starts up unless its
        first toggle is at 0.0), over ``[0, horizon]``."""
        out = []
        for k in range(self.n_nodes):
            e = None if self.churn is None else self.churn[k]
            if e is None:
                out.append(())
            elif isinstance(e, PeriodicChurn):
                out.append(e.toggles(horizon))
            else:
                t = []
                for down, up in e:
                    t.append(down)
                    t.append(up)
                out.append(tuple(t))
        return tuple(out)

    def churn_operand(self, horizon: float):
        """The availability schedule as the K-node loop's (K, E) f64
        toggle-time operand, padded with `BIG` and with at least one
        all-`BIG` trailing column (so a node's cursor can rest past its
        last toggle), or ``None`` when no node toggles over ``[0,
        horizon]``: the run then takes the plain loop, bitwise."""
        toggles = self.churn_toggles(horizon)
        if not any(len(t) for t in toggles):
            return None
        E = max(len(t) for t in toggles) + 1
        churn_t = np.full((self.n_nodes, E), BIG, np.float64)
        for k, tg in enumerate(toggles):
            churn_t[k, : len(tg)] = tg
        return churn_t

    def node_caps(self, capacity: int) -> Tuple[int, ...]:
        """Per-node slot counts given the capacity-axis value."""
        if self.node_capacity is not None:
            return self.node_capacity
        return (int(capacity),) * self.n_nodes

    def get_router(self):
        from repro_torch.cluster.routers import get_router
        return get_router(self.router)

    def validate(self) -> "ClusterSpec":
        """Raise with a precise message on the first bad field; returns
        self."""
        if self.n_nodes < 1:
            raise ValueError(
                f"ClusterSpec: n_nodes must be >= 1, got {self.n_nodes}")
        self.get_router()               # KeyError lists registered
        if self.node_capacity is not None:
            if len(self.node_capacity) != self.n_nodes:
                raise ValueError(
                    f"ClusterSpec: node_capacity has "
                    f"{len(self.node_capacity)} entries for "
                    f"{self.n_nodes} nodes")
            if any(c <= 0 for c in self.node_capacity):
                _bad("node_capacity",
                     f"node capacities must be > 0, got "
                     f"{self.node_capacity}")
        raw = (self.net_delay if isinstance(self.net_delay, tuple)
               else (self.net_delay,) * self.n_nodes)
        if len(raw) != self.n_nodes:
            raise ValueError(
                f"ClusterSpec: net_delay has {len(raw)} entries for "
                f"{self.n_nodes} nodes")
        for k, x in enumerate(raw):
            if math.isnan(x):
                _bad("net_delay", f"entry {k} is NaN")
            if x < 0 or math.isinf(x):
                _bad("net_delay",
                     f"entry {k} must be finite and >= 0, got {x}")
        if self.delay_schedule is not None:
            if len(self.delay_schedule) != self.n_nodes:
                _bad("delay_schedule",
                     f"has {len(self.delay_schedule)} entries for "
                     f"{self.n_nodes} nodes")
            for k, ds in enumerate(self.delay_schedule):
                if ds is None:
                    continue
                if not isinstance(ds, DelaySchedule):
                    raise TypeError(
                        f"ClusterSpec.delay_schedule: entry {k} must "
                        f"be DelaySchedule or None, got "
                        f"{type(ds).__name__}")
                ds.validate(f"delay_schedule[{k}]")
        if self.churn is not None:
            if len(self.churn) != self.n_nodes:
                _bad("churn", f"has {len(self.churn)} entries for "
                              f"{self.n_nodes} nodes")
            for k, e in enumerate(self.churn):
                self._validate_churn_entry(k, e)
        if self.weights is not None:
            if len(self.weights) != self.n_nodes:
                raise ValueError(
                    f"ClusterSpec: weights has {len(self.weights)} "
                    f"entries for {self.n_nodes} nodes")
            if any(w <= 0 for w in self.weights):
                raise ValueError(
                    f"ClusterSpec: weights must be positive, got "
                    f"{self.weights}")
        return self

    @staticmethod
    def _validate_churn_entry(k: int, e: ChurnEntry):
        field = f"churn[{k}]"
        if e is None:
            return
        if isinstance(e, PeriodicChurn):
            e.validate(field)
            return
        prev_up = None
        for i, win in enumerate(e):
            if len(win) != 2:
                _bad(field, f"window {i} must be (down_at, up_at), "
                            f"got {win}")
            down, up = win
            if math.isnan(down) or math.isnan(up):
                _bad(field, f"window {i} contains NaN: {win}")
            if not (0.0 <= down < up) or math.isinf(up):
                _bad(field, f"window {i} needs 0 <= down_at < up_at "
                            f"< inf, got {win}")
            if prev_up is not None and down <= prev_up:
                _bad(field, f"windows must be strictly increasing and "
                            f"non-overlapping; window {i} starts at "
                            f"{down} but the previous window ends at "
                            f"{prev_up}")
            prev_up = up

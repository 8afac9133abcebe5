"""`ClusterSpec`: one declared multi-node edge cluster topology
(counterpart of `repro.cluster.spec`, without churn and delay
schedules).

The paper schedules functions on a *single* resource-limited edge
server; real edge deployments are K small nodes behind a request
router. A `ClusterSpec` declares that topology (node count, per-node
slot capacities, the router and its knobs) as one frozen value that
rides the `repro_torch.api.ExperimentSpec` ``cluster`` axis.

The port runs the static routers (``hash``, ``round_robin``,
``weighted_random``) on the static tier (`repro_torch.cluster.static`)
and the dynamic ones (``jsq2``, ``cold_aware``, ``slo_aware`` and any
registered `DynamicRouter`) on the K-node event loop
(`repro_torch.cluster.engine`). The ``churn`` and ``delay_schedule``
fields (ROADMAP Queue 1, item 2) raise NotImplementedError, and so does
the ``breaker`` router when it runs (item 3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

NOT_PORTED = {
    "churn": "node churn is not ported yet: ROADMAP Queue 1, item 2",
    "delay_schedule": ("time-varying network delay is not ported yet: "
                       "ROADMAP Queue 1, item 2"),
}


def _bad(field: str, msg: str):
    raise ValueError(f"ClusterSpec.{field}: {msg}")


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
    ``churn``, ``delay_schedule``: not ported (ROADMAP Queue 1, item 2);
                      anything but ``None`` raises.
    """

    n_nodes: int = 2
    router: str = "hash"
    node_capacity: Optional[Tuple[int, ...]] = None
    net_delay: Union[float, Tuple[float, ...]] = 0.0
    seed: int = 0
    weights: Optional[Tuple[float, ...]] = None
    churn: Optional[object] = None
    delay_schedule: Optional[object] = None

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

    # ---------------------------------------------------------- helpers
    @property
    def label(self) -> str:
        """Coordinate label on the ResultSet cluster axis, router first:
        ``hash:K2x[8,4]``-style, as the JAX package labels it."""
        tag = f"{self.router}:K{self.n_nodes}"
        if self.node_capacity is not None:
            caps = set(self.node_capacity)
            tag += (f"x{self.node_capacity[0]}" if len(caps) == 1
                    else "x" + ",".join(map(str, self.node_capacity)))
        if any(self.delays()):
            tag += "+d"
        return tag

    def delays(self) -> Tuple[float, ...]:
        """Per-node constant network delays, expanded to length K."""
        if isinstance(self.net_delay, tuple):
            return self.net_delay
        return (self.net_delay,) * self.n_nodes

    def node_caps(self, capacity: int) -> Tuple[int, ...]:
        """Per-node slot counts given the capacity-axis value."""
        if self.node_capacity is not None:
            return self.node_capacity
        return (int(capacity),) * self.n_nodes

    def get_router(self):
        from repro_torch.cluster.routers import get_router
        return get_router(self.router)

    def validate(self) -> "ClusterSpec":
        """Raise with a precise message on the first bad field (and
        NotImplementedError on an unported one); returns self."""
        for name, why in NOT_PORTED.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(f"ClusterSpec.{name}: {why}")
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

"""Multi-node edge clusters (counterpart of `repro.cluster`): the
`ClusterSpec` topology, the routers, the static routing tier (a K-node
cluster as K single-node engine runs over the per-node sub-streams,
merged exactly) and the dynamic tier (`repro_torch.cluster.engine`: K
nodes in one event loop a lane, routed by live state: jsq2, cold_aware,
slo_aware, with constant or time-varying (`DelaySchedule`) per-node
network delays and node churn (`PeriodicChurn` or explicit windows:
drain, park and re-route), and the resilience layer's circuit breaker
(`BreakerRouter`, registered as ``breaker``); and the Python reference
cluster (`simulate_cluster_reference`: K ordinary Python engines behind
the routers, the oracle the K-node loops are held to)."""
from repro_torch.cluster.routers import (BreakerRouter, ClusterView,
                                         DynamicRouter, Router,
                                         StaticRouter,
                                         available_routers, get_router,
                                         register_router,
                                         unregister_router)
from repro_torch.cluster.reference import simulate_cluster_reference
from repro_torch.cluster.spec import (ClusterSpec, DelaySchedule,
                                      PeriodicChurn)

__all__ = ["BreakerRouter", "ClusterSpec", "ClusterView", "DelaySchedule",
           "PeriodicChurn", "DynamicRouter", "Router", "StaticRouter",
           "available_routers", "get_router", "register_router",
           "simulate_cluster_reference", "unregister_router"]

"""Multi-node edge clusters (counterpart of `repro.cluster`): the
`ClusterSpec` topology, the routers and the static routing tier, where
a K-node cluster is K single-node engine runs over the per-node
sub-streams, merged exactly. The dynamic tier is not ported (ROADMAP
Queue 1, item 1)."""
from repro_torch.cluster.routers import (Router, StaticRouter,
                                         available_routers, get_router,
                                         register_router,
                                         unregister_router)
from repro_torch.cluster.spec import ClusterSpec

__all__ = ["ClusterSpec", "Router", "StaticRouter", "available_routers",
           "get_router", "register_router", "unregister_router"]

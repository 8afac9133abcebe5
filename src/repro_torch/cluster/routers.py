"""Request routers and the router registry (counterpart of
`repro.cluster.routers`, its static tier).

A router decides *which node* of a `repro_torch.cluster.ClusterSpec`
serves each request; the node's own scheduling policy decides the rest.

* `StaticRouter`: the node is a pure function of the trace (``assign``
  maps the whole arrival stream to node ids in one vectorised pass).
  These run on the static tier (`repro_torch.cluster.static`): per-node
  sub-streams through the single-node engine, metrics merged exactly.
* `DynamicRouter`: the node depends on live cluster state, so it needs
  the K-node event loop, which is not ported (ROADMAP Queue 1, item 1).
  The JAX package's dynamic routers are registered by name so that a
  spec naming one validates and then raises NotImplementedError.

Randomised routers draw from the counter-based `mix32` hash of the
request id, so a decision depends only on ``(rid, seed)`` and the port
routes exactly as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9          # seed spreader (golden-ratio constant)
_MIX1, _MIX2 = 0x85EBCA6B, 0xC2B2AE35   # murmur3 fmix32 constants

DYNAMIC_NOT_PORTED = ("the dynamic cluster tier (the K-node event loop) "
                      "is not ported yet: ROADMAP Queue 1, item 1")


def mix32_py(x: int, seed: int = 0) -> int:
    """murmur3-style finaliser over ``x ^ spread(seed)`` on Python ints:
    the scalar reference the vectorised variant must match."""
    h = (int(x) ^ ((seed * _GOLD) & _M32)) & _M32
    h ^= h >> 16
    h = (h * _MIX1) & _M32
    h ^= h >> 13
    h = (h * _MIX2) & _M32
    h ^= h >> 16
    return h


def mix32_np(x, seed: int = 0) -> np.ndarray:
    """Vectorised `mix32_py` on a numpy integer array."""
    h = np.asarray(x).astype(np.uint64)
    h = (h ^ ((seed * _GOLD) & _M32)) & _M32
    h ^= h >> np.uint64(16)
    h = (h * _MIX1) & _M32
    h ^= h >> np.uint64(13)
    h = (h * _MIX2) & _M32
    h ^= h >> np.uint64(16)
    return h.astype(np.int64)


class Router:
    """Base class: subclass `StaticRouter` (or `DynamicRouter`)."""

    name = "base"
    dynamic = False


class StaticRouter(Router):
    """Node choice is a pure function of the trace."""

    def assign(self, fn_id: np.ndarray, arrival: np.ndarray,
               spec) -> np.ndarray:
        """(N,) int node ids in [0, spec.n_nodes)."""
        raise NotImplementedError


class DynamicRouter(Router):
    """Node choice reads live cluster state at each arrival: the K-node
    event loop it needs is not ported (ROADMAP Queue 1, item 1)."""

    dynamic = True

    def __init__(self, name: str):
        self.name = name

    def pick(self, g, j, rid, t):
        raise NotImplementedError(f"router {self.name!r}: "
                                  f"{DYNAMIC_NOT_PORTED}")


# ------------------------------------------------------- static builtins
class HashRouter(StaticRouter):
    """Function-affinity hashing: every invocation of f_j lands on the
    same node (``mix32(j, seed) % K``), the sticky routing that maximises
    warm reuse and accepts imbalance."""

    name = "hash"

    def assign(self, fn_id, arrival, spec):
        return (mix32_np(fn_id, spec.seed)
                % spec.n_nodes).astype(np.int32)


class RoundRobinRouter(StaticRouter):
    """Global round-robin over the arrival sequence: perfect request
    balance, worst-case warm-instance dilution."""

    name = "round_robin"

    def assign(self, fn_id, arrival, spec):
        return (np.arange(len(fn_id), dtype=np.int64)
                % spec.n_nodes).astype(np.int32)


class WeightedRandomRouter(StaticRouter):
    """Seeded weighted-random spread (default uniform): node k drawn with
    probability weight_k / sum(weights) per request id."""

    name = "weighted_random"

    def assign(self, fn_id, arrival, spec):
        w = np.asarray(spec.weights if spec.weights is not None
                       else [1.0] * spec.n_nodes, np.float64)
        cum = np.cumsum(w / w.sum())
        u = (mix32_np(np.arange(len(fn_id)), spec.seed)
             + 0.5) / 2.0 ** 32
        return np.minimum(np.searchsorted(cum, u, side="right"),
                          spec.n_nodes - 1).astype(np.int32)


ROUTERS: Dict[str, Router] = {
    "hash": HashRouter(),
    "round_robin": RoundRobinRouter(),
    "weighted_random": WeightedRandomRouter(),
    # the JAX package's dynamic routers, by name only
    "jsq2": DynamicRouter("jsq2"),
    "cold_aware": DynamicRouter("cold_aware"),
    "slo_aware": DynamicRouter("slo_aware"),
    "breaker": DynamicRouter("breaker"),
}


def available_routers() -> List[str]:
    """Registered router names (built-ins + `register_router` adds)."""
    return sorted(ROUTERS)


def get_router(name: str) -> Router:
    """Router registered under ``name`` (KeyError lists what exists)."""
    try:
        return ROUTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown router {name!r}; registered routers: "
            f"{sorted(ROUTERS)} (add your own with "
            "repro_torch.cluster.register_router)") from None


def register_router(name: str, router: Router, *,
                    replace: bool = False) -> Router:
    """Register a `Router` instance under ``name`` (``replace=True`` to
    overwrite an existing name). Returns ``router``."""
    if not isinstance(router, Router):
        raise TypeError(
            f"register_router({name!r}): expected a Router *instance* "
            f"(got {type(router).__name__}); subclass "
            "repro_torch.cluster.routers.StaticRouter and pass an "
            "instance")
    if not name or not isinstance(name, str):
        raise ValueError("register_router: name must be a non-empty "
                         "string")
    if name in ROUTERS and not replace:
        raise ValueError(
            f"register_router: router {name!r} is already registered "
            f"(to {type(ROUTERS[name]).__name__}); pass replace=True "
            "to overwrite deliberately")
    ROUTERS[name] = router
    return router


def unregister_router(name: str) -> None:
    """Remove a registered router."""
    if name not in ROUTERS:
        raise KeyError(f"unregister_router: {name!r} is not registered")
    del ROUTERS[name]

"""Request routers and the router registry (counterpart of
`repro.cluster.routers`).

A router decides *which node* of a `repro_torch.cluster.ClusterSpec`
serves each request; the node's own scheduling policy decides the rest.

* `StaticRouter`: the node is a pure function of the trace (``assign``
  maps the whole arrival stream to node ids in one vectorised pass).
  These run on the static tier (`repro_torch.cluster.static`): per-node
  sub-streams through the single-node engine, metrics merged exactly.
* `DynamicRouter`: the node depends on live cluster state (queue
  depths, warm instances), so ``pick`` runs inside the K-node event
  loop (`repro_torch.cluster.engine`) once an arrival, on a lane-batched
  `ClusterView`. The built-ins ``jsq2`` (`JSQRouter`), ``cold_aware``
  and ``slo_aware`` also run inside the event-loop kernel's K-node
  variant (`ROUTER_CODES`), and so does ``breaker``, the circuit
  breaker of the resilience layer (`BreakerRouter`) around one of them;
  any other `DynamicRouter` runs on the eager loop.

Randomised routers draw from the counter-based `mix32` hash of the
request id, so a decision depends only on ``(rid, seed)`` and the port
routes exactly as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, List

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
I32_MAX = 2 ** 31 - 1       # a down node's load
_GOLD = 0x9E3779B9          # seed spreader (golden-ratio constant)
_MIX1, _MIX2 = 0x85EBCA6B, 0xC2B2AE35   # murmur3 fmix32 constants

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


def _mul32(h, m: int):
    """``(h * m) mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit
    constant ``m``, in two 16-bit halves so that no product overflows
    int64."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_torch(x, seed):
    """`mix32_py` on int64 tensors ``x`` (request ids) and ``seed``
    (broadcast against ``x``), in int64 lanes on any device."""
    h = (x & _M32) ^ _mul32(seed & _M32, _GOLD)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


class ClusterView:
    """What a `DynamicRouter.pick` reads, lane-batched (counterpart of
    `repro.cluster.routers.ClusterView`, one lane of which it holds per
    row): queue depths ``q_len`` (L, K, F) with the per-node totals
    ``q_tot`` (L, K), slot rails ``slot_fn`` / ``slot_state`` and
    ``cap_mask`` (L, K, C), per-node estimator state ``est_sum`` /
    ``est_n`` (L, K, F) with node globals ``node_gn`` / ``node_gsum``
    (L, K), the lane's function catalogue ``t_cold`` (L, F), the
    estimator ``prior`` (float), the node count ``n_nodes`` (L,) with
    ``node_ok`` (L, K) (False on the padding nodes of a lane with fewer
    nodes than K), the hash ``seed`` (L,), ``delay_now`` (L, K), each
    node's network delay at the decision (zero rows on a lane without
    delay), ``up`` (L, K) bool, False on a node that is down (None
    when no lane has churn), and ``brk_until`` (L, K) f64, each node's
    circuit-breaker reopen time (0: closed; None unless a lane's router
    is a `BreakerRouter`). Node-axis reductions must skip the padding
    nodes; the engine clips a pick to [0, n_nodes), as the JAX package
    clips to [0, K), and re-aims a pick of a down node at the lowest-id
    up node."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Router:
    """Base class: subclass `StaticRouter` or `DynamicRouter`."""

    name = "base"
    dynamic = False


class StaticRouter(Router):
    """Node choice is a pure function of the trace."""

    def assign(self, fn_id: np.ndarray, arrival: np.ndarray,
               spec) -> np.ndarray:
        """(N,) int node ids in [0, spec.n_nodes)."""
        raise NotImplementedError


class DynamicRouter(Router):
    """Node choice reads live cluster state at each arrival."""

    dynamic = True

    def pick(self, g: ClusterView, j, rid, t):
        """(L,) int64 node ids for the arriving requests ``rid`` (L,) of
        functions ``j`` (L,) at times ``t`` (L,); ``g`` is the
        lane-batched `ClusterView` of the state before the event."""
        raise NotImplementedError


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


# ------------------------------------------------------ dynamic builtins
def _busy(g):
    """Busy usable slots a node, (L, K) int64."""
    return ((g.slot_state == 2) & g.cap_mask).sum(-1)


class JSQRouter(DynamicRouter):
    """JSQ(d) / power-of-d-choices: hash-sample ``d`` distinct nodes (a
    partial Fisher-Yates draw over the node ids: position i swaps with
    ``i + mix32(rid, seed + i) % (K - i)``), send the request to the
    least loaded (load = queued + running; ties keep the earliest
    draw). At K = 1 every draw is node 0."""

    def __init__(self, name: str = "jsq2", d: int = 2):
        self.name = name
        self.d = int(d)

    @staticmethod
    def sample(rid, seed: int, K: int, d: int, mix=mix32_py):
        """The (i, j) swaps of the first min(d, K) positions of a partial
        Fisher-Yates shuffle of range(K): position i swaps with ``i +
        mix(rid, seed + i) % (K - i)``. `pick` and the Python reference
        cluster replay the same swaps, so their candidates match."""
        return [(i, i + int(mix(rid, seed + i) % (K - i)))
                for i in range(min(d, K))]

    def pick(self, g, j, rid, t):
        L, Kx = g.q_tot.shape
        K = g.n_nodes
        load = g.q_tot.to(torch.int64) + _busy(g)
        up = getattr(g, "up", None)
        if up is not None:
            load = torch.where(up, load, I32_MAX)
        nodes = torch.arange(Kx, device=rid.device).expand(L, Kx).clone()
        lanes = torch.arange(L, device=rid.device)
        for i in range(min(self.d, Kx)):
            on = i < K
            span = torch.clamp_min(K - i, 1)
            jd = torch.where(on, i + mix32_torch(rid, g.seed + i) % span, i)
            ni, nj = nodes[:, i].clone(), nodes[lanes, jd]
            nodes[:, i] = nj
            nodes[lanes, jd] = ni
        best = nodes[:, 0]
        for i in range(1, min(self.d, Kx)):
            cand = nodes[:, i]
            better = (i < K) & (load[lanes, cand] < load[lanes, best])
            best = torch.where(better, cand, best)
        return best


def startability_score(g, j):
    """Per-node estimate of the time until a request of function ``j``
    could start there, (L, K) f64, in the reference's order of
    operations (`repro.cluster.routers._startability_score`): no cold
    start when the node has an idle warm instance of ``j``, plus ``j``'s
    backlog at the node's running mean of ``j`` (its global mean, then
    the prior, as fallback), plus the node's whole backlog and busy
    slots at its global mean."""
    F = g.q_len.shape[2]
    jc = j.clamp(0, F - 1)
    gn = g.node_gn.to(torch.float64)
    gmean = torch.where(g.node_gn > 0,
                        g.node_gsum / torch.clamp_min(gn, 1), g.prior)
    col = jc[:, None, None].expand(-1, g.q_len.shape[1], 1)
    n_j = g.est_n.gather(2, col)[..., 0]
    mean_j = torch.where(
        n_j > 0,
        g.est_sum.gather(2, col)[..., 0]
        / torch.clamp_min(n_j.to(torch.float64), 1), gmean)
    own = (g.slot_fn == jc[:, None, None]) & g.cap_mask
    has_idle = (own & (g.slot_state == 1)).any(-1)
    tc = g.t_cold.gather(1, jc[:, None])
    q_j = g.q_len.gather(2, col)[..., 0].to(torch.float64)
    backlog = (g.q_tot.to(torch.int64) + _busy(g)).to(torch.float64)
    return (torch.where(has_idle, 0.0, tc) + mean_j * q_j) + gmean * backlog


def _first_argmin(g, score):
    """The first node of least ``score`` among the lane's nodes; a down
    node scores `BIG` (1e30), as a padding node does."""
    ok = g.node_ok
    up = getattr(g, "up", None)
    if up is not None:
        ok = ok & up
    return torch.argmin(torch.where(ok, score, 1e30), dim=1)


class ColdAwareRouter(DynamicRouter):
    """Cold-start-aware routing: the node of least `startability_score`
    (ties: the lowest node id)."""

    name = "cold_aware"

    def pick(self, g, j, rid, t):
        return _first_argmin(g, startability_score(g, j))


class SLOAwareRouter(DynamicRouter):
    """SLO-aware routing: the node of least ``delay_now + score`` (the
    predicted response), ties to the lowest node id. Without delay it is
    ``cold_aware``; under a delay schedule it weighs each link as it is
    at the decision."""

    name = "slo_aware"

    def pick(self, g, j, rid, t):
        return _first_argmin(g, startability_score(g, j) + g.delay_now)


class BreakerRouter(DynamicRouter):
    """Circuit breaker around another dynamic router (counterpart of
    `repro.cluster.routers.BreakerRouter`).

    Per node, completed attempts count in tumbling windows of ``volume``;
    when a full window's failures and timeouts reach ``trip_at = max(1,
    ceil(volume * threshold))`` the breaker trips and the node gets no
    routed request for ``cooldown`` seconds. Then it is half-open: it is
    routable, and the first attempt that completes there decides (a
    success closes the breaker, a failure trips it again). When every
    candidate node is tripped the breaker fails open (routes as if it
    were not there). The engine keeps the state (``brk_until``: 0 when
    closed, the reopen time while open). Without a failure source it
    never trips and routes as ``inner``."""

    def __init__(self, inner: "DynamicRouter", name: str = "breaker", *,
                 threshold: float = 0.5, volume: int = 20,
                 cooldown: float = 30.0):
        if not isinstance(inner, DynamicRouter):
            raise TypeError(
                "BreakerRouter wraps a DynamicRouter instance, got "
                f"{type(inner).__name__}")
        if not (0.0 < threshold <= 1.0):
            raise ValueError("BreakerRouter threshold must be in (0, 1]")
        if volume < 1 or cooldown <= 0:
            raise ValueError(
                "BreakerRouter needs volume >= 1 and cooldown > 0")
        self.inner = inner
        self.name = name
        self.threshold = float(threshold)
        self.volume = int(volume)
        self.cooldown = float(cooldown)
        # a full window trips iff its failures reach trip_at
        self.trip_at = max(1, int(math.ceil(self.volume * self.threshold)))

    def pick(self, g, j, rid, t):
        base_up = g.node_ok if getattr(g, "up", None) is None else g.up
        eff = base_up & (g.brk_until <= t[:, None])
        eff = torch.where(eff.any(1, keepdim=True), eff, base_up)
        return self.inner.pick(ClusterView(**{**g.__dict__, "up": eff}),
                               j, rid, t)


# the dynamic routers that the event-loop kernel's K-node variant runs,
# by their exact class: the code of its route, then JSQ's d
ROUTER_CODES = {JSQRouter: 0, ColdAwareRouter: 1, SLOAwareRouter: 2}
# a breaker's code: its inner router's, with this bit set
BREAKER_BIT = 4


def has_device_route(router) -> bool:
    """Whether the K-node variant runs ``router``: a built-in dynamic
    router, or a `BreakerRouter` around one (by exact class)."""
    if type(router) is BreakerRouter:
        router = router.inner
    return type(router) in ROUTER_CODES


def router_code(router) -> tuple:
    """``(code, d)`` of a dynamic router that the kernel runs (a breaker:
    its inner router's code with `BREAKER_BIT` set); ValueError for any
    other."""
    brk = type(router) is BreakerRouter
    inner = router.inner if brk else router
    code = ROUTER_CODES.get(type(inner))
    if code is None:
        raise ValueError(f"router {router.name!r} "
                         f"({type(router).__name__}) has no device route")
    return code | (BREAKER_BIT if brk else 0), (inner.d if code == 0 else 0)


ROUTERS: Dict[str, Router] = {
    "hash": HashRouter(),
    "round_robin": RoundRobinRouter(),
    "weighted_random": WeightedRandomRouter(),
    "jsq2": JSQRouter("jsq2", d=2),
    "cold_aware": ColdAwareRouter(),
    "slo_aware": SLOAwareRouter(),
    "breaker": BreakerRouter(JSQRouter("jsq2", d=2)),
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
            "repro_torch.cluster.routers.StaticRouter or DynamicRouter "
            "and pass an instance")
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

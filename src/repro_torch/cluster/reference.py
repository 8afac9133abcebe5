"""Straightforward Python reference cluster: router + K event engines
(counterpart of `repro.cluster.reference`, on the port's own Python
core).

The slow oracle that the port's K-node loops are held to request for
request: K ordinary single-node simulations -- each node its own
`repro_torch.core.server.EdgeServer` + `ExecTimeEstimator` +
event-driven policy instance, untouched -- sharing **one** global
`EventQueue`, so simultaneous events interleave across nodes exactly as
the paper's single-server engine orders them (EXEC_DONE < COLD_DONE <
TIMER < NODE_ARRIVAL < REROUTE < CHURN < RETRY < ARRIVAL, FIFO within a
kind). At each ARRIVAL the router picks the node from live global state
with the *same arithmetic* (the same `mix32_py` draws, score formula and
first-argmin tie-break) as the port's routers in
`repro_torch.cluster.routers` (`_pick_dynamic`, a Python mirror of their
tensor arithmetic, which it never calls), then hands the request to
that node's policy.

Churn is mirrored with two extra event kinds driven by the spec's
`churn_toggles` expansion: a CHURN toggle on an up node drains it --
requests running on it (by request id) then its queued requests
(function-major, FIFO within a function) re-enter the router as REROUTE
events at the failure instant, every instance dies (cold state lost;
the execution-time estimator, router-side, persists) -- while a toggle
on a down node re-emits any parked requests. A request is *parked*
whenever it needs a node and none is up (a fresh arrival, a re-route,
or a delivery landing on a down node with no alternative); parked
requests replay in FIFO order at the next NODE_UP. Routers see an
``up`` mask and may still name a down node (every sampled JSQ candidate
is down); the lowest-id up node then takes it, as in the engines. Under
churn the response is the completion minus the *raw* arrival (the
delivery leg may be paid several times).

The resilience layer is mirrored with the shared pre-planned outcomes of
`repro_torch.core.resilience.plan_outcomes`: the effective execution time
(``min(exec, timeout)``) is substituted into the requests, and at each
EXEC_DONE the attempt counter decides success (``attempt > n_fail``). A
failed attempt frees its slot like a success but erases the completion;
with budget left it re-enters after ``backoff_py`` through a FIFO retry
rail (head-armed RETRY events, no overtaking: one rail a node on the
static tier, one for the cluster on the dynamic tier). ``queue_cap`` +
``on_overflow`` reproduce admission control after the fact: when an
admitted request leaves a per-function queue longer than the cap,
``shed`` removes the newcomer and ``shed_oldest`` the queue head
(terminal, counted ``shed``), while ``error`` drops the newcomer and
counts ``overflow``. A `BreakerRouter` keeps a (count, failures,
open-until) window a node, updated at EXEC_DONE with the engines'
closed / half-open / open transitions.

Nodes only interact through the router, so the cross-node order of
same-time non-arrival events does not matter: this composition is a
faithful reference for the K-node loops' node-major tie-breaking. The
Python float arithmetic (the backoff, `DelaySchedule.at`, the raw
arrival plus a delay) is the JAX package's operation for operation, so
the two references agree bitwise.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.cluster.routers import (BreakerRouter, DynamicRouter,
                                         JSQRouter, SLOAwareRouter)
from repro_torch.cluster.spec import ClusterSpec
from repro_torch.core.events import EventKind, EventQueue
from repro_torch.core.policy import POLICIES
from repro_torch.core.request import Trace
from repro_torch.core.server import (EdgeServer, ExecTimeEstimator,
                                     InstanceState)

_I32_MAX = 2**31 - 1
_BIG = 1e30


def _queues(policy) -> dict:
    """The per-function waiting deques, whatever the policy calls
    them (`queues` for per-function-queue policies, `fifo` for the
    central-queue family)."""
    if hasattr(policy, "queues"):
        return policy.queues
    if hasattr(policy, "fifo"):
        return policy.fifo
    raise TypeError(
        f"policy {policy.name!r} exposes no queue structure the "
        "reference router can read")


def _busy(server: EdgeServer) -> int:
    return sum(1 for i in server.instances.values()
               if i.state == InstanceState.BUSY)


def _pick_dynamic(router: DynamicRouter, servers, policies, ests,
                  functions, rid: int, fn: int, seed: int,
                  prior: float, up=None, delay_now=None) -> int:
    """Python mirror of the arithmetic of `DynamicRouter.pick` (the
    port's routers pick on tensors; this mirror is plain Python).

    ``up`` (length-K bools) masks down nodes exactly like the routers'
    view: JSQ loads become I32_MAX, score routers get BIG -- the
    chosen node may still be down (caller applies the lowest-id-up
    correction). ``delay_now`` is the per-node delay in effect at the
    decision instant (the `slo_aware` delay term)."""
    K = len(servers)
    if K == 1:
        return 0
    if isinstance(router, JSQRouter):
        load = [sum(len(q) for q in _queues(p).values()) + _busy(s)
                for p, s in zip(policies, servers)]
        if up is not None:
            load = [ld if u else _I32_MAX for ld, u in zip(load, up)]
        nodes = list(range(K))
        for i, jd in JSQRouter.sample(rid, seed, K, router.d):
            nodes[i], nodes[jd] = nodes[jd], nodes[i]
        best = nodes[0]
        for i in range(1, min(router.d, K)):
            if load[nodes[i]] < load[best]:
                best = nodes[i]
        return best
    # cold_aware / slo_aware: estimated time-to-start per node (plus
    # the current network delay for slo_aware), first argmin
    slo = isinstance(router, SLOAwareRouter)
    best_k, best_score = 0, None
    for k, (srv, pol, est) in enumerate(zip(servers, policies, ests)):
        gmean = est.gsum / max(est.gn, 1) if est.gn > 0 else prior
        n_j = est.n[fn]
        mean_j = est.sum[fn] / max(n_j, 1) if n_j > 0 else gmean
        has_idle = srv.idle_of(fn) is not None
        qtot = sum(len(q) for q in _queues(pol).values())
        score = ((0.0 if has_idle else functions[fn].cold_start)
                 + mean_j * len(_queues(pol)[fn])
                 + gmean * (qtot + _busy(srv)))
        if slo and delay_now is not None:
            score += delay_now[k]
        if up is not None and not up[k]:
            score = _BIG
        if best_score is None or score < best_score:
            best_k, best_score = k, score
    return best_k


def simulate_cluster_reference(trace: Trace, policy_name: str,
                               cspec: ClusterSpec, *,
                               capacity: Optional[int] = None,
                               exec_prior: float = 0.1,
                               max_events: Optional[int] = None,
                               deadlines: Optional[Sequence[float]]
                               = None,
                               horizon: Optional[float] = None,
                               queue_cap: Optional[int] = None,
                               fail_prob=0.0,
                               timeouts=None,
                               retry=None,
                               on_overflow: str = "error",
                               fail_seed: int = 0,
                               event_log: Optional[list] = None
                               ) -> Dict[str, np.ndarray]:
    """Run ``policy_name`` on a K-node cluster over ``trace``.

    ``capacity`` is the per-node slot count when the spec leaves
    ``node_capacity`` unset. Returns per-request ``start`` /
    ``completion`` / ``response`` (original request order), the (N,)
    node ``assign``ment, per-node ``node_done`` / ``node_cold`` counts
    and the cluster totals; with ``deadlines`` ((F,) per-function SLO
    deadlines) also the per-function ``deadline_miss`` counts
    (``response > deadline``, the engine's predicate).

    ``fail_prob`` / ``timeouts`` / ``retry`` (a `RetryPolicy`) /
    ``on_overflow`` + ``queue_cap`` switch on the resilience layer
    (module docstring) with the same trivial-off gate as the engine:
    all-zero ``fail_prob``, no ``timeouts`` and ``on_overflow=
    "error"`` leaves every code path untouched. The extra counters
    (``failed`` / ``timed_out`` / ``retried`` / ``shed`` /
    ``failed_exhausted`` / ``breaker_trips``) are always returned.

    ``event_log``, when a list, receives one ``(kind, rid, fn, node,
    t)`` tuple per processed event in pop order, with
    `repro_torch.telemetry.rail.TraceKind` codes -- the ground truth the
    engines' trace rail is parity-tested against. ``node`` is -1
    where no node is defined (a parked request, a rid-less churn
    toggle's request field).
    """
    from repro_torch.core.resilience import (SHED_MODES, RetryPolicy,
                                             backoff_py, plan_outcomes)
    cspec.validate()
    K = cspec.n_nodes
    caps = cspec.node_caps(capacity if capacity is not None else 0)
    if any(c < 1 for c in caps):
        raise ValueError("simulate_cluster_reference: pass capacity= "
                         "or set ClusterSpec.node_capacity")
    router = cspec.get_router()
    delays = cspec.delays()
    if horizon is None:
        # the runner expands toggles against the horizon of the whole
        # stacked trace axis; pass it explicitly when comparing
        # against a multi-trace engine run
        horizon = (max(r.arrival for r in trace.requests)
                   if trace.requests else 0.0)
    toggles = cspec.churn_toggles(horizon)
    has_churn = any(len(t) for t in toggles)
    if has_churn and not router.dynamic:
        raise ValueError(
            "churn requires a dynamic router (static assignment "
            "cannot re-route around a down node); got "
            f"router={cspec.router!r}")
    dscheds = cspec.delay_schedule
    var_delay = dscheds is not None and any(
        ds is not None and len(ds.values) > 1 for ds in dscheds)

    # ---------------------------------------------- resilience layer
    if on_overflow not in SHED_MODES:
        raise ValueError(f"on_overflow must be one of "
                         f"{sorted(SHED_MODES)}, got {on_overflow!r}")
    shed_mode = SHED_MODES[on_overflow]
    fp = np.atleast_1d(np.asarray(fail_prob, np.float64))
    has_resil = (bool(np.any(fp > 0)) or timeouts is not None
                 or on_overflow != "error")
    has_breaker = isinstance(router, BreakerRouter)
    N = len(trace.requests)
    fn_ids = np.array([r.fn_id for r in trace.requests], np.int64)
    orig_exec = np.array([r.exec_time for r in trace.requests])
    if has_resil:
        if retry is None:
            retry = RetryPolicy()
        max_att = int(retry.max_attempts)
        eff_exec, n_fail, is_tmo = plan_outcomes(
            fn_ids, orig_exec, fail_prob=fail_prob, timeouts=timeouts,
            max_attempts=max_att, n_fns=trace.n_functions,
            seed=fail_seed)
        for r, e in zip(trace.requests, eff_exec):
            r.exec_time = float(e)
    att = np.zeros((N,), np.int32)
    counts = dict(failed=0, timed_out=0, retried=0, shed=0,
                  failed_exhausted=0, breaker_trips=0, overflow=0)
    # one retry rail per node on the static tier (independent
    # single-node engines), one cluster-global rail otherwise
    retry_qs = [deque() for _ in range(K if not router.dynamic else 1)]
    brk_n = [0] * K
    brk_f = [0] * K
    brk_until = [0.0] * K

    def delay_at(k: int, t: float) -> float:
        if var_delay:
            ds = dscheds[k]
            if ds is not None and len(ds.values) > 1:
                return ds.at(t)
        return delays[k]

    events = EventQueue()
    servers = [EdgeServer(trace.functions, caps[k], events)
               for k in range(K)]
    ests = [ExecTimeEstimator(trace.n_functions, prior=exec_prior)
            for _ in range(K)]
    policies = []
    for k in range(K):
        pol = POLICIES[policy_name]()
        pol.bind(servers[k], ests[k])
        policies.append(pol)

    assign = np.full((N,), -1, np.int32)
    static_assign = None
    if not router.dynamic:
        a = trace.to_arrays()
        static_assign = np.asarray(
            router.assign(a["fn_id"], a["arrival"], cspec))

    deferred = router.dynamic and (any(delays) or var_delay)
    for r in trace.requests:
        r.start = -1.0
        r.completion = -1.0
        if static_assign is not None:
            # the node is known upfront; the request reaches it after
            # its network delay
            k = int(static_assign[r.req_id])
            events.push(r.arrival + delays[k], EventKind.ARRIVAL, r)
        else:
            events.push(r.arrival, EventKind.ARRIVAL, r)
    # node-major toggle pushes: same-time toggles of different nodes
    # resolve lowest-node-first, the engine's candidate tie-break
    up = [True] * K
    for k in range(K):
        for t in toggles[k]:
            events.push(t, EventKind.CHURN, k)
    parked: list = []   # FIFO of requests waiting for any node

    def owner(inst) -> int:
        for k, srv in enumerate(servers):
            if srv.instances.get(inst.inst_id) is inst:
                return k
        raise RuntimeError(f"instance {inst.inst_id} owned by no node")

    def admit(k: int, req, t: float) -> None:
        # hand the request to the node's policy, then apply the
        # admission-control cap post-hoc: the policy's queues are
        # uncapped, so a push that left the per-function queue longer
        # than ``queue_cap`` is exactly an engine push onto a full
        # queue — ``shed`` removes the newcomer (the tail), ``shed_
        # oldest`` the head, ``error`` drops the newcomer and counts
        # overflow (the legacy invalid-run behaviour)
        policies[k].on_arrival(req, t)
        if not has_resil or queue_cap is None:
            return
        q = _queues(policies[k]).get(req.fn_id)
        if q is None or len(q) <= queue_cap:
            return
        if shed_mode == 2:
            victim = q.popleft()
            counts["shed"] += 1
            victim.completion = -1.0
        elif q[-1] is req:
            q.pop()
            if shed_mode == 1:
                counts["shed"] += 1
            else:
                counts["overflow"] += 1

    def route(req, t: float) -> None:
        dn = [delay_at(i, t) for i in range(K)]
        pick_router = router
        pick_up = up if has_churn else None
        if has_breaker:
            # mask breaker-open nodes for the inner router's pick,
            # failing open when every live node is open -- the routers'
            # `BreakerRouter.pick` arithmetic
            base_up = pick_up if pick_up is not None else [True] * K
            eff = [u and brk_until[i] <= t
                   for i, u in enumerate(base_up)]
            if not any(eff):
                eff = list(base_up)
            pick_router, pick_up = router.inner, eff
        k = _pick_dynamic(pick_router, servers, policies, ests,
                          trace.functions, req.req_id, req.fn_id,
                          cspec.seed, exec_prior,
                          up=pick_up, delay_now=dn)
        if has_churn and not up[k]:
            k = up.index(True)   # lowest-id up node, engine's argmax
        assign[req.req_id] = k
        if deferred:
            # dynamic routing under net_delay: the decision is made
            # now, the node sees the request delay_k(t) later
            events.push(t + delay_at(k, t), EventKind.NODE_ARRIVAL,
                        req)
        else:
            admit(k, req, t)

    def retry_rail(req) -> deque:
        return retry_qs[int(assign[req.req_id])
                        if not router.dynamic else 0]

    def retry_push(req, elig: float) -> None:
        # FIFO rail, head-armed: only the head has a RETRY event in
        # flight; the successor is armed at pop time with
        # ``max(elig, pop time)`` (no overtaking)
        rail = retry_rail(req)
        if not rail:
            events.push(elig, EventKind.RETRY, req)
        rail.append((req, elig))

    from repro_torch.telemetry.rail import TraceKind

    if event_log is not None:
        def log(kind, req, node, t, fn=None):
            event_log.append((
                int(kind),
                -1 if req is None else int(req.req_id),
                (int(fn) if fn is not None
                 else -1 if req is None else int(req.fn_id)),
                int(node), float(t)))
    else:
        def log(kind, req, node, t, fn=None):
            pass

    node_done = np.zeros((K,), np.int64)
    n_events = 0
    while True:
        ev = events.pop()
        if ev is None:
            break
        n_events += 1
        if max_events is not None and n_events > max_events:
            raise RuntimeError(f"event budget exceeded ({max_events})")
        if ev.kind == EventKind.ARRIVAL:
            req = ev.payload
            if static_assign is not None:
                k = int(static_assign[req.req_id])
                assign[req.req_id] = k
                admit(k, req, ev.time)
                log(TraceKind.ARRIVAL, req, k, ev.time)
            elif has_churn and not any(up):
                parked.append(req)
                log(TraceKind.ARRIVAL, req, -1, ev.time)
            else:
                route(req, ev.time)
                log(TraceKind.ARRIVAL, req, assign[req.req_id],
                    ev.time)
        elif ev.kind == EventKind.NODE_ARRIVAL:
            req = ev.payload
            k = int(assign[req.req_id])
            log(TraceKind.NODE_ARRIVAL, req, k, ev.time)
            if has_churn and not up[k]:
                # landed on a down node: back through the router (or
                # park if there is nowhere to go)
                if any(up):
                    events.push(ev.time, EventKind.REROUTE, req)
                else:
                    parked.append(req)
            else:
                admit(k, req, ev.time)
        elif ev.kind == EventKind.RETRY:
            req = ev.payload
            rail = retry_rail(req)
            assert rail and rail[0][0] is req
            rail.popleft()
            if rail:
                nreq, nelig = rail[0]
                events.push(max(nelig, ev.time), EventKind.RETRY,
                            nreq)
            if static_assign is not None:
                # static tier: the retry re-enters its own node's
                # queue at the fire time (the delivery leg is not
                # re-paid — the request never left the node)
                admit(int(assign[req.req_id]), req, ev.time)
                log(TraceKind.RETRY, req, assign[req.req_id],
                    ev.time)
            elif has_churn and not any(up):
                parked.append(req)
                log(TraceKind.RETRY, req, -1, ev.time)
            else:
                route(req, ev.time)
                log(TraceKind.RETRY, req, assign[req.req_id],
                    ev.time)
        elif ev.kind == EventKind.REROUTE:
            req = ev.payload
            if not any(up):
                parked.append(req)
                log(TraceKind.REROUTE, req, -1, ev.time)
            else:
                route(req, ev.time)
                log(TraceKind.REROUTE, req, assign[req.req_id],
                    ev.time)
        elif ev.kind == EventKind.CHURN:
            k = ev.payload
            log(TraceKind.CHURN, None, k, ev.time)
            if up[k]:
                # NODE_DOWN: drain running requests (by request id)
                # then queued ones (function-major, FIFO within a
                # function); every instance dies, cold state is lost,
                # the estimator persists
                up[k] = False
                srv, pol = servers[k], policies[k]
                running = sorted(
                    (i for i in srv.instances.values()
                     if i.state == InstanceState.BUSY
                     and i.current is not None),
                    key=lambda i: i.current.req_id)
                drained = [i.current for i in running]
                q = _queues(pol)
                for fn in sorted(q):
                    drained.extend(q[fn])
                for inst in srv.instances.values():
                    inst.dead = True   # pending *_DONE events no-op
                srv.instances.clear()
                srv.by_fn = {f.fn_id: set()
                             for f in trace.functions}
                fresh = POLICIES[policy_name]()
                fresh.bind(srv, ests[k])
                policies[k] = fresh
                for req in drained:
                    events.push(ev.time, EventKind.REROUTE, req)
            else:
                # NODE_UP: replay parked requests in arrival order
                up[k] = True
                for req in parked:
                    events.push(ev.time, EventKind.REROUTE, req)
                parked.clear()
        elif ev.kind == EventKind.EXEC_DONE:
            inst = ev.payload
            if getattr(inst, "dead", False):
                continue
            k = owner(inst)
            req = inst.current
            log(TraceKind.EXEC, req, k, ev.time)
            ests[k].observe(req.fn_id, req.exec_time)
            ok = True
            if has_resil:
                # the pre-planned attempt test (core/resilience.py):
                # the engine counts attempts at dispatch, this
                # reference at completion — equal here because a
                # churn-drained attempt reaches neither
                att[req.req_id] += 1
                a = int(att[req.req_id])
                ok = a > int(n_fail[req.req_id])
            if ok:
                node_done[k] += 1
            if has_breaker:
                # engine-exact window transitions: closed counts the
                # attempt and trips on a full window's failures;
                # half-open lets the first completion decide; open
                # completions are pre-trip stragglers, ignored
                u0 = brk_until[k]
                if u0 == 0.0:  # closed
                    brk_n[k] += 1
                    brk_f[k] += 0 if ok else 1
                    if brk_n[k] >= router.volume:
                        if brk_f[k] >= router.trip_at:
                            brk_until[k] = ev.time + router.cooldown
                            counts["breaker_trips"] += 1
                        brk_n[k] = brk_f[k] = 0
                elif u0 <= ev.time:  # half-open: first result decides
                    if ok:
                        brk_until[k] = 0.0
                    else:
                        brk_until[k] = ev.time + router.cooldown
                        counts["breaker_trips"] += 1
                    brk_n[k] = brk_f[k] = 0
            policies[k].on_exec_done(inst, req, ev.time)
            if not ok:
                req.completion = -1.0
                if is_tmo[req.req_id]:
                    counts["timed_out"] += 1
                else:
                    counts["failed"] += 1
                if a >= max_att:
                    counts["failed_exhausted"] += 1
                else:
                    counts["retried"] += 1
                    retry_push(req, ev.time + backoff_py(
                        a, req.req_id, retry.base, retry.cap,
                        retry.jitter, fail_seed))
        elif ev.kind == EventKind.COLD_DONE:
            inst = ev.payload
            if getattr(inst, "dead", False):
                continue
            ko = owner(inst)
            log(TraceKind.COLD, None, ko, ev.time, fn=inst.fn_id)
            policies[ko].on_cold_done(inst, ev.time)
        elif ev.kind == EventKind.TIMER:
            if has_churn or has_resil:
                raise RuntimeError(
                    "timer-armed policies are not supported under "
                    "churn or the resilience layer (matches the "
                    "engine's rejection)")
            # timer payloads are requests; route to the node that owns
            # the request (openwhisk_v2 on the static path)
            req = ev.payload
            k = int(assign[req.req_id])
            log(TraceKind.TIMER, req, k, ev.time)
            if k >= 0:
                policies[k].on_timer(req, ev.time)

    start = np.array([r.start for r in trace.requests])
    completion = np.array([r.completion for r in trace.requests])
    arr = np.array([r.arrival for r in trace.requests])
    if has_resil:
        # restore the pre-substitution execution times so the trace
        # can be replayed (min(exec, timeout) is not idempotent for
        # the timeout classification)
        for r, e in zip(trace.requests, orig_exec):
            r.exec_time = float(e)
    if has_churn or (has_resil and router.dynamic):
        # the delivery leg may be paid several times for a re-routed
        # or retried request, so the response baseline is the raw
        # arrival (the static tier keeps its per-node delayed clock —
        # a retry never leaves its node)
        pass
    elif static_assign is not None:
        # response measured from the node-local (delayed) arrival,
        # the engine's convention (docs/cluster.md)
        arr = arr + np.asarray(delays)[static_assign]
    elif deferred:
        ka = np.clip(assign, 0, K - 1)
        if var_delay:
            arr = arr + np.array([delay_at(int(k), float(a))
                                  for k, a in zip(ka, arr)])
        else:
            arr = arr + np.asarray(delays)[ka]
    response = completion - arr
    if has_resil:
        response = np.where(completion >= 0.0, response, np.nan)
    out = dict(
        start=start, completion=completion, response=response,
        assign=assign, node_done=node_done,
        node_cold=np.array([s.stats.cold_starts for s in servers]),
        cold_starts=int(sum(s.stats.cold_starts for s in servers)),
        evictions=int(sum(s.stats.evictions for s in servers)),
        n_events=n_events, done=int((completion >= 0.0).sum()),
        **counts)
    if deadlines is not None:
        dl = np.asarray(deadlines, np.float64)
        fn = np.array([r.fn_id for r in trace.requests])
        miss = np.zeros((trace.n_functions,), np.int32)
        done = completion >= 0.0
        np.add.at(miss, fn[done & (response > dl[fn])], 1)
        out["deadline_miss"] = miss
    return out

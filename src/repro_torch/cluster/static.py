"""The static routing tier: pre-partition, simulate, merge exactly
(counterpart of `repro.cluster.static`).

A static router fixes each request's node from the trace alone, so a
K-node cluster is exactly K independent single-node simulations over the
per-node sub-streams of the arrival stream:

1. ``build_node_streams`` asks the router for the (N,) node assignment
   (checking that every request is routed exactly once), splits the
   columnar trace into K arrival-ordered sub-streams, adds each node's
   network delay to its arrivals (a constant shift keeps a sub-stream
   sorted) and right-pads every sub-stream to the common length N
   (``fn_id`` 0, ``arrival`` 1e30, ``exec_time`` 0). The engine's
   ``n_live`` lane bound keeps the padding inert.
2. ``run_static_entries`` lowers (policy x entry x trace x node x
   capacity x beta) onto engine lanes: every (entry, trace, node)
   sub-stream is one row of a shared operand, node slot counts become
   per-lane capacity masks over the largest node, and one engine call
   runs a lane chunk of every static entry of a spec (one launch of the
   event-loop kernel a policy and lane chunk on a card, where the JAX
   package calls its engine once a sub-stream). Lanes are independent,
   so the packing changes no bit.
3. ``merge_node_metrics`` folds the per-node metrics back into cluster
   cells: counters and histograms are integer sums, the float sums are
   taken in canonical (value-sorted) order over the node axis, in numpy
   as the JAX package does (`_ordered_sum`), so that the merge is
   bitwise invariant to node numbering, and the means and the quantile
   are recomputed from the merged sums and histogram as the engine
   computes them: a K = 1 cluster with zero delay is bitwise the plain
   single-node run.

Under resilience each sub-stream carries its requests' pre-planned
outcome rows, sliced by the same partition, with their *original*
request ids as the jitter keys (a request backs off alike on every node
and tier), and the merged means and quantiles reduce over the merged
successes (``done``).

A request routed to node k *arrives at the node* at ``t + delay_k``, and
its response is measured from that node-local arrival.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.cluster.spec import ClusterSpec

PAD_ARRIVAL = 1e30      # the engine's BIG: padding never arrives


def build_node_streams(arrays: Dict[str, np.ndarray], cspec: ClusterSpec):
    """Partition one columnar trace into per-node padded sub-streams.

    Returns ``(assign, streams, n_live, index)``: the (N,) node
    assignment, a dict of (K, N) padded ``fn_id``/``arrival``/
    ``exec_time`` rows (node k's requests lead row k, arrival order
    kept, delays applied), the (K,) live lengths and the K
    original-request-id index arrays (for exact-mode reassembly)."""
    router = cspec.get_router()
    if router.dynamic:
        raise ValueError(
            f"build_node_streams: router {cspec.router!r} is dynamic: it "
            "routes inside the K-node event loop "
            "(repro_torch.cluster.engine), not by a partition")
    if cspec.has_churn():
        raise ValueError(
            f"cluster router {cspec.router!r} is static: a fixed "
            "assignment cannot re-route around a down node. Churn "
            "needs a dynamic router (jsq2, cold_aware, slo_aware)")
    if cspec.delay_ops() is not None:
        raise ValueError(
            f"cluster router {cspec.router!r} is static: the "
            "pre-partition fast path only supports constant "
            "net_delay (a time-varying DelaySchedule would unsort "
            "the per-node sub-streams); use a dynamic router")
    fn_id = np.asarray(arrays["fn_id"])
    arrival = np.asarray(arrays["arrival"])
    N, K = len(fn_id), cspec.n_nodes
    assign = np.asarray(router.assign(fn_id, arrival, cspec))
    if assign.shape != (N,):
        raise ValueError(
            f"router {cspec.router!r} returned shape {assign.shape} for "
            f"{N} requests: every request must be routed exactly once")
    if N and (assign.min() < 0 or assign.max() >= K):
        raise ValueError(
            f"router {cspec.router!r} routed outside [0, {K}): range "
            f"[{assign.min()}, {assign.max()}]")
    delays = cspec.delays()
    node_fn = np.zeros((K, N), np.int32)
    node_arr = np.full((K, N), PAD_ARRIVAL, np.float64)
    node_ex = np.zeros((K, N), np.float64)
    n_live = np.zeros((K,), np.int32)
    index: List[np.ndarray] = []
    for k in range(K):
        idx = np.flatnonzero(assign == k)
        n = len(idx)
        node_fn[k, :n] = fn_id[idx]
        node_arr[k, :n] = arrival[idx] + delays[k]
        node_ex[k, :n] = np.asarray(arrays["exec_time"])[idx]
        n_live[k] = n
        index.append(idx)
    streams = dict(fn_id=node_fn, arrival=node_arr, exec_time=node_ex)
    return assign, streams, n_live, index


# ------------------------------------------------------------ exact merge
# float metrics summed over nodes in canonical (value-sorted) order so
# that the merged value is bitwise invariant to node numbering; integer
# metrics sum in any order (n_events too: the port's results carry it);
# the maximum is order-free
_SUM_F = ("resp_sum", "slow_sum", "cold_time", "evict_time",
          "tl_resp_sum", "tl_exec_sum")
_SUM_I = ("cold_starts", "evictions", "overflow", "stalled", "done",
          "n_events", "resp_hist", "deadline_miss", "tl_count", "failed",
          "timed_out", "retried", "shed", "failed_exhausted")


def _ordered_sum(a: np.ndarray, axis: int) -> np.ndarray:
    """Sum over ``axis`` with the addends first sorted by value: numpy's
    pairwise summation over a sorted axis, deterministic and
    permutation-invariant."""
    return np.sort(a, axis=axis).sum(axis=axis)


def _mean(x: np.ndarray, n: int) -> np.ndarray:
    """``x / n`` as the engine spells a constant denominator (XLA folds
    the division into a reciprocal multiply; a plain numpy divide would
    differ in the last ulp and break the K = 1 bitwise gate)."""
    return x * (1.0 / max(int(n), 1))


def merge_node_metrics(per_node: Dict[str, np.ndarray], node_axis: int,
                       n_total: int, resil: bool = False
                       ) -> Dict[str, np.ndarray]:
    """Fold per-node metric arrays (node axis ``node_axis``, >= 0) into
    cluster-level metrics over ``n_total`` requests; the means and the
    streamed p99 are recomputed from the merged sums and histogram the
    way `engine.sweep_metrics` computes them (under ``resil`` over the
    merged ``done``: an array denominator, a plain division)."""
    from repro_torch.core.engine import hist_quantile
    out: Dict[str, np.ndarray] = {}
    for m in _SUM_F:
        if m in per_node:
            out[m] = _ordered_sum(per_node[m], node_axis)
    for m in _SUM_I:
        if m in per_node:
            out[m] = per_node[m].sum(axis=node_axis)
    out["max_response"] = per_node["max_response"].max(axis=node_axis)
    out["node_done"] = np.moveaxis(per_node["done"], node_axis, -1)
    if resil:
        den = np.maximum(out["done"], 1).astype(np.float64)
        out["mean_response"] = out["resp_sum"] / den
        out["mean_slowdown"] = out["slow_sum"] / den
        nq = torch.from_numpy(out["done"][..., None])
    else:
        out["mean_response"] = _mean(out["resp_sum"], n_total)
        out["mean_slowdown"] = _mean(out["slow_sum"], n_total)
        nq = n_total
    out["p99_response"] = hist_quantile(
        torch.from_numpy(out["resp_hist"]), 0.99, nq,
        torch.from_numpy(out["max_response"])).numpy()
    return out


def pack_static_lanes(spec, entries, stacked: Dict[str, np.ndarray],
                      rs=None):
    """The static tier's lanes for ``entries`` (static `ClusterSpec`s) of
    ``spec``: every (entry, trace, node) sub-stream is a row of one
    shared (R, N) operand, and the lanes run entry-major, then trace,
    node, capacity, beta. Returns ``(rows, lanes, layout)``: the row
    columns (numpy, engine layout; under resilience, ``rs`` of
    `ExperimentSpec.resilience_ops` with ``stacked``'s exec times already
    its attempts' times, also ``rs_nfail``, ``rs_tmo`` and ``rs_key``,
    each request's outcome row and original id, zero on the padding),
    the lane columns ``trace_ix``, ``cap_mask`` (over the largest node's
    slots), ``n_live`` and ``beta_ix`` (into the beta axis), and per
    entry ``(K, n_live (T, K), index[t][k])`` for the merge."""
    T = stacked["fn_id"].shape[0]
    B = 1 if spec.betas is None else len(spec.betas)
    C = max(max(e.node_caps(c)) for e in entries for c in spec.capacities)
    rows = {k: [] for k in ("fn_id", "arrival", "exec_time", "cold_start",
                            "evict")}
    if rs is not None:
        for k in ("rs_nfail", "rs_tmo", "rs_key"):
            rows[k] = []
    tix, masks, n_live, bix = [], [], [], []
    layout = []
    for e in entries:
        Kn = e.n_nodes
        nl_rows = np.zeros((T, Kn), np.int64)
        index = []
        for t in range(T):
            a = {k: stacked[k][t] for k in ("fn_id", "arrival",
                                            "exec_time")}
            _, streams, nl, idx = build_node_streams(a, e)
            nl_rows[t] = nl
            index.append(idx)
            for k in range(Kn):
                r = len(rows["fn_id"])
                for key in ("fn_id", "arrival", "exec_time"):
                    rows[key].append(streams[key][k])
                if rs is not None:
                    i = idx[k]
                    n = len(rs[1][t])
                    for key, full, dt in (("rs_nfail", rs[1][t], np.int32),
                                          ("rs_tmo", rs[2][t], bool),
                                          ("rs_key", np.arange(n), np.int32)):
                        row = np.zeros(n, dt)
                        row[:len(i)] = full[i]
                        rows[key].append(row)
                rows["cold_start"].append(stacked["cold_start"][t])
                rows["evict"].append(stacked["evict"][t])
                for c in spec.capacities:
                    for b in range(B):
                        tix.append(r)
                        masks.append(np.arange(C) < e.node_caps(c)[k])
                        n_live.append(nl[k])
                        bix.append(b)
        layout.append((Kn, nl_rows, index))
    lanes = dict(trace_ix=np.asarray(tix, np.int64),
                 cap_mask=np.stack(masks),
                 n_live=np.asarray(n_live, np.int64),
                 beta_ix=np.asarray(bix, np.int64))
    return {k: np.stack(v) for k, v in rows.items()}, lanes, layout


def static_calls(spec, entries, stacked: Dict[str, np.ndarray], F: int,
                 kernels: dict, betas: Dict[str, np.ndarray], deadlines,
                 device, chunk: int, rs=None):
    """The static tier's engine calls for ``entries`` of ``spec``: the
    lanes of `pack_static_lanes`, ``chunk`` of them a call, policy-major.
    Returns ``(calls, L, layout)``: ``calls`` a list of ``(policy, lo,
    hi, args, kw)``, each one call ``sweep_metrics(*args, **kw)`` over
    lanes [lo, hi) on ``device``; ``betas[policy]`` is the policy's (B,)
    beta axis, ``deadlines`` the (F,) operand or None, ``rs`` the
    resilience operands (`pack_static_lanes`) or None."""
    from repro_torch.api.runner import trace_operands
    rows, lanes, layout = pack_static_lanes(spec, entries, stacked, rs)
    C = lanes["cap_mask"].shape[1]
    shared = list(trace_operands(rows, device).values())
    L = len(lanes["trace_ix"])
    rs_kw = {}
    if rs is not None:
        rs_kw = {k: torch.as_tensor(rows[k], device=device)
                 for k in ("rs_nfail", "rs_tmo", "rs_key")}
        rs_kw["resil"] = rs[4]

    def col(x, lo, hi):
        return torch.as_tensor(x[lo:hi], device=device)

    calls = []
    for policy in spec.policies:
        beta_l = np.asarray(betas[policy], np.float64)[lanes["beta_ix"]]
        for lo in range(0, L, chunk):
            hi = min(lo + chunk, L)
            args = (*shared, col(lanes["trace_ix"], lo, hi),
                    col(lanes["cap_mask"], lo, hi), col(beta_l, lo, hi),
                    spec.prior, spec.threshold)
            kw = dict(kernel=kernels[policy], n_fns=F, capacity=C,
                      queue_cap=spec.queue_cap, stream=spec.stream,
                      keep_responses=not spec.stream,
                      n_live=col(lanes["n_live"], lo, hi),
                      deadlines=deadlines, window=spec.window,
                      tl_bins=spec.tl_bins, tl_bucket=spec.tl_bucket,
                      trace=spec.trace_events, **rs_kw)
            calls.append((policy, lo, hi, args, kw))
    return calls, L, layout


def merge_static_lanes(spec, layout, flat: Dict[str, np.ndarray],
                       N: int, resil: bool = False
                       ) -> List[Dict[str, np.ndarray]]:
    """One policy's per-lane metrics ``flat`` (lanes in `pack_static_lanes`
    order, numpy) merged into one (T, KC, B)-shaped metric dict an entry
    of ``layout`` (under ``resil`` over the successes: a shed or
    exhausted request's response is NaN)."""
    KC = len(spec.capacities)
    B = 1 if spec.betas is None else len(spec.betas)
    out, lo = [], 0
    for Kn, nl_rows, index in layout:
        T = nl_rows.shape[0]
        n_lanes = T * Kn * KC * B
        # (T, K, KC, B, ...) -> (T, KC, B, K, ...)
        pn = {m: np.moveaxis(v[lo:lo + n_lanes].reshape(
                  (T, Kn, KC, B) + v.shape[1:]), 1, 3)
              for m, v in flat.items()}
        merged = merge_node_metrics(pn, node_axis=3, n_total=N, resil=resil)
        if "response" in pn:
            resp = np.zeros((T, KC, B, N), np.float64)
            for t in range(T):
                for k in range(Kn):
                    nk = int(nl_rows[t, k])
                    resp[t, :, :, index[t][k]] = np.moveaxis(
                        pn["response"][t, :, :, k, :nk], -1, 0)
            merged["p99_response"] = (
                np.nanpercentile(resp, 99.0, axis=-1) if resil
                else np.percentile(resp, 99.0, axis=-1))
            if spec.keep_per_request:
                merged["response"] = resp
        out.append(merged)
        lo += n_lanes
    return out


def static_trace_cells(spec, layout, lane_events: Dict[int, dict],
                       pi: int, cells: List[Dict[tuple, dict]]) -> None:
    """Policy ``pi``'s per-lane event streams ``lane_events`` (lanes in
    `pack_static_lanes` order) as one stream a cell, into ``cells`` (one
    dict an entry of ``layout``, keyed (pi, t, kc, b)): each sub-stream's
    local request ids mapped back to the global ids through the
    partition index, its node patched in (the single-node engine records
    -1), and a cell's K streams merged in time order
    (`repro_torch.telemetry.rail.merge_events`), as the JAX package's
    static tier does."""
    from repro_torch.telemetry.rail import merge_events
    KC = len(spec.capacities)
    B = 1 if spec.betas is None else len(spec.betas)
    lo = 0
    for j, (Kn, nl_rows, index) in enumerate(layout):
        T = nl_rows.shape[0]
        for t in range(T):
            for kc in range(KC):
                for b in range(B):
                    evs = []
                    for k in range(Kn):
                        ev = dict(lane_events[
                            lo + ((t * Kn + k) * KC + kc) * B + b])
                        ev["node"] = np.full_like(ev["node"], k)
                        idxk, r = index[t][k], ev["rid"]
                        if len(idxk):
                            gl = idxk[np.clip(r, 0, len(idxk) - 1)]
                            ev["rid"] = np.where(r >= 0, gl,
                                                 -1).astype(np.int32)
                        evs.append(ev)
                    cells[j][(pi, t, kc, b)] = merge_events(evs)
        lo += T * Kn * KC * B


def run_static_entries(spec, entries, stacked: Dict[str, np.ndarray],
                       F: int, N: int, kernels: dict,
                       betas: Dict[str, np.ndarray], deadlines, device,
                       chunk: int, rs=None, trace_cells=None
                       ) -> List[Dict[str, np.ndarray]]:
    """Run the static `ClusterSpec` ``entries`` of ``spec`` over its grid
    on ``device``; one (P, T, KC, B)-shaped metric dict an entry (plus
    trailing dims: ``node_done`` (.., K), ``resp_hist`` (.., bins), ...).

    The engine calls are `static_calls`'; ``betas[policy]`` is the
    policy's (B,) beta axis, ``deadlines`` the (F,) operand or None,
    ``rs`` the resilience operands or None. Under ``spec.trace_events``
    each call runs in its own collection scope and ``trace_cells`` (a
    list) gets one dict of cell streams an entry (`static_trace_cells`)."""
    from repro_torch.api.runner import to_numpy, traced_call
    from repro_torch.core.engine import sweep_metrics
    calls, L, layout = static_calls(spec, entries, stacked, F, kernels,
                                    betas, deadlines, device, chunk, rs)
    flat: Dict[str, Dict[str, np.ndarray]] = {p: {} for p in spec.policies}
    lane_events: Dict[str, Dict[int, dict]] = {p: {}
                                               for p in spec.policies}
    for policy, lo, hi, args, kw in calls:
        out, events = traced_call(
            lambda: to_numpy(sweep_metrics(*args, **kw)),
            spec.trace_events, hi - lo)
        for j, ev in enumerate(events or ()):
            lane_events[policy][lo + j] = ev
        for k, v in out.items():
            if k not in flat[policy]:
                flat[policy][k] = np.zeros((L,) + v.shape[1:], v.dtype)
            flat[policy][k][lo:hi] = v
    if spec.trace_events and trace_cells is not None:
        trace_cells[:] = [{} for _ in layout]
        for pi, p in enumerate(spec.policies):
            static_trace_cells(spec, layout, lane_events[p], pi,
                               trace_cells)
    merged = [merge_static_lanes(spec, layout, flat[p], N, rs is not None)
              for p in spec.policies]
    return [{m: np.stack([per_entry[j][m] for per_entry in merged])
             for m in merged[0][j]} for j in range(len(layout))]

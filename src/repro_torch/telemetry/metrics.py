"""Streaming time-series metrics derived from trace-event streams
(counterpart of `repro.telemetry.metrics`).

Generalises the engines' coarse ``tl_bins`` occupancy counters: from
one cell's event stream, :func:`timeline` computes per-bin per-node
queue depth, warm-instance occupancy, utilization, throughput,
goodput and rolling SLO attainment — all host-side, after the engine
run, so the event loops stay untouched. Exporters cover CSV and the
Prometheus text exposition format (both dependency-free).

The rail's ``qlen`` / ``warm`` / ``busy`` snapshots are the *event
node's own* post-event counters (the single-node tier is the K=1
special case), so per-node series are exact forward-fills of each
node's last observation and the global series are their sums.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.rail import (AUX_FAIL_EXHAUSTED, AUX_FAIL_RETRY,
                                  AUX_SHED, TraceKind)


def _last_per_bin(bix: np.ndarray, val: np.ndarray,
                  nbins: int) -> np.ndarray:
    """Last observed ``val`` per bin, forward-filled across empty
    bins (NaN before the first observation)."""
    out = np.full(nbins, np.nan)
    if len(bix):
        out[bix] = val  # later events overwrite: last wins
    for i in range(1, nbins):
        if np.isnan(out[i]):
            out[i] = out[i - 1]
    return out


def timeline(events: Dict[str, np.ndarray], *, bucket: float = 1.0,
             n_nodes: Optional[int] = None,
             capacity: Optional[int] = None,
             deadlines=None,
             t_end: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Per-bin time series from one columnar event stream.

    Returns a dict of arrays — ``t`` (left bin edges, shape (B,)),
    global ``queue_total`` / ``warm`` / ``busy`` (B,), per-node
    ``queue_depth`` / ``arrivals`` / ``busy_time`` /
    ``utilization`` (B, K), plus ``throughput`` / ``goodput`` (req/s,
    (B,)) and ``slo_attainment`` / ``slo_rolling`` ((B,), NaN where
    no completions; requires ``deadlines`` per function id)."""
    kind = np.asarray(events["kind"])
    # the single-node tier records node -1: everything is node 0
    node = np.maximum(np.asarray(events["node"]), 0)
    t = np.asarray(events["t"], np.float64)
    dt = np.asarray(events["dt"], np.float64)
    aux = np.asarray(events["aux"])
    K = int(n_nodes if n_nodes is not None
            else (node.max() + 1 if len(node) else 1))
    hi = float(t_end if t_end is not None
               else (t.max() if len(t) else bucket))
    B = max(1, int(np.ceil(hi / bucket + 1e-9)))
    edges = np.arange(B) * bucket
    bix = np.minimum((t / bucket).astype(np.int64), B - 1)

    out: Dict[str, np.ndarray] = {"t": edges}

    # qlen/warm/busy snapshots are per-node: forward-fill each node's
    # own observations (0 before its first event), sum for the global
    def per_node(field):
        col = np.zeros((B, K))
        for k in range(K):
            m = node == k
            col[:, k] = np.nan_to_num(
                _last_per_bin(bix[m], np.asarray(events[field])[m], B))
        return col

    depth = per_node("qlen")
    out["queue_depth"] = depth
    out["queue_total"] = depth.sum(axis=1)
    out["warm"] = per_node("warm").sum(axis=1)
    out["busy"] = per_node("busy").sum(axis=1)

    arr = np.zeros((B, K))
    m = (kind == TraceKind.ARRIVAL) & (node >= 0) & (node < K)
    np.add.at(arr, (bix[m], node[m]), 1.0)
    out["arrivals"] = arr

    # utilization: EXEC slices clipped onto bins, per node
    busy_time = np.zeros((B, K))
    ex = np.flatnonzero(kind == TraceKind.EXEC)
    for i in ex:
        k = int(node[i])
        if not 0 <= k < K:
            continue
        lo, hicl = float(t[i] - dt[i]), float(t[i])
        b0 = min(max(int(lo / bucket), 0), B - 1)
        b1 = min(max(int(hicl / bucket - 1e-12), 0), B - 1)
        for b in range(b0, b1 + 1):
            busy_time[b, k] += (min(hicl, (b + 1) * bucket)
                                - max(lo, b * bucket))
    out["busy_time"] = busy_time
    cap = float(capacity) if capacity else 1.0
    out["utilization"] = busy_time / (bucket * cap)

    ok = (kind == TraceKind.EXEC) & (
        (aux & (AUX_FAIL_RETRY | AUX_FAIL_EXHAUSTED)) == 0)
    thr = np.zeros(B)
    np.add.at(thr, bix[ok], 1.0)
    out["throughput"] = thr / bucket

    # SLO attainment / goodput need per-rid arrival times
    rid = np.asarray(events["rid"])
    fn = np.asarray(events["fn"])
    arr_t: Dict[int, float] = {}
    am = kind == TraceKind.ARRIVAL
    for i in np.flatnonzero(am):
        arr_t.setdefault(int(rid[i]), float(t[i]))
    met = np.zeros(B)
    tot = np.zeros(B)
    good = np.zeros(B)
    if deadlines is not None:
        dl = np.asarray(deadlines, np.float64)
        for i in np.flatnonzero(ok):
            a = arr_t.get(int(rid[i]))
            if a is None:
                continue
            f = int(fn[i])
            d = float(dl[f]) if dl.ndim else float(dl)
            b = bix[i]
            tot[b] += 1
            if t[i] - a <= d:
                met[b] += 1
                good[b] += 1
    out["goodput"] = good / bucket
    with np.errstate(invalid="ignore", divide="ignore"):
        out["slo_attainment"] = np.where(tot > 0, met / tot, np.nan)
        ctot, cmet = np.cumsum(tot), np.cumsum(met)
        out["slo_rolling"] = np.where(ctot > 0, cmet / ctot, np.nan)
    return out


def timeline_to_csv(tl: Dict[str, np.ndarray], path) -> None:
    """Wide CSV: one row per bin; per-node columns suffixed ``_k<i>``."""
    cols, names = [], []
    for name, a in tl.items():
        a = np.asarray(a)
        if a.ndim == 1:
            names.append(name)
            cols.append(a)
        else:
            for k in range(a.shape[1]):
                names.append(f"{name}_k{k}")
                cols.append(a[:, k])
    with open(path, "w") as fh:
        fh.write(",".join(names) + "\n")
        for row in zip(*cols):
            fh.write(",".join(f"{v:.9g}" for v in row) + "\n")


def events_summary(events: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Terminal counters of one event stream (Prometheus source)."""
    kind = np.asarray(events["kind"])
    aux = np.asarray(events["aux"])
    ok = (kind == TraceKind.EXEC) & (
        (aux & (AUX_FAIL_RETRY | AUX_FAIL_EXHAUSTED)) == 0)
    return dict(
        arrivals=int((kind == TraceKind.ARRIVAL).sum()),
        completions=int(ok.sum()),
        executions=int((kind == TraceKind.EXEC).sum()),
        cold_starts=int((kind == TraceKind.COLD).sum()),
        retries=int((kind == TraceKind.RETRY).sum()),
        reroutes=int((kind == TraceKind.REROUTE).sum()),
        shed=int(((kind == TraceKind.ARRIVAL)
                  & ((aux & AUX_SHED) != 0)).sum()),
    )


def to_prometheus(events: Dict[str, np.ndarray], *,
                  tl: Optional[Dict[str, np.ndarray]] = None,
                  prefix: str = "repro",
                  labels: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition (version 0.0.4) of one stream.

    Event totals become counters; when a :func:`timeline` dict is
    given, its final-bin values become per-node gauges."""
    lab = "".join(f'{k}="{v}",' for k, v in (labels or {}).items())
    base = f"{{{lab[:-1]}}}" if lab else ""
    lines = []

    def counter(name, val, extra=""):
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} counter")
        tag = (f"{{{lab}{extra}}}" if extra
               else base) if (lab or extra) else ""
        lines.append(f"{full}{tag} {val}")

    def gauge(name, val, extra=""):
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} gauge")
        if lab or extra:
            tag = f"{{{lab}{extra}}}".replace(",}", "}")
        else:
            tag = ""
        lines.append(f"{full}{tag} {val:.9g}")

    for name, val in events_summary(events).items():
        counter(f"{name}_total", val)
    if tl is not None:
        depth = np.asarray(tl["queue_depth"])
        for k in range(depth.shape[1]):
            gauge("queue_depth", float(depth[-1, k]),
                  extra=f'node="{k}"')
        for g in ("warm", "busy"):
            v = float(np.asarray(tl[g])[-1])
            if not np.isnan(v):
                gauge(f"{g}_instances", v)
        sr = np.asarray(tl["slo_rolling"])
        if len(sr) and not np.isnan(sr[-1]):
            gauge("slo_attainment", float(sr[-1]))
    return "\n".join(lines) + "\n"

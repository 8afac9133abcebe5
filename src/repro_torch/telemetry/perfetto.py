"""Chrome/Perfetto ``trace_event`` JSON export (counterpart of
`repro.telemetry.perfetto`).

Maps one cell's event stream onto the Trace Event Format accepted by
Perfetto (ui.perfetto.dev) and chrome://tracing: each cluster node is
a *process*, each warm slot's function a *thread*, executions are
complete slices (``ph="X"``) and routing events are instants
(``ph="i"``). Sim-time seconds become microsecond timestamps.

Dependency-free: stdlib ``json`` only.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.rail import (AUX_COLD, AUX_FAIL_EXHAUSTED,
                                  AUX_FAIL_RETRY, AUX_OVERFLOW,
                                  AUX_QUEUED, AUX_SHED, AUX_TIMEOUT,
                                  TraceKind)

_US = 1e6  # sim seconds -> trace microseconds

_ARR_BITS = ((AUX_COLD, "cold"), (AUX_QUEUED, "queued"),
             (AUX_SHED, "shed"), (AUX_OVERFLOW, "overflow"))
_EXEC_BITS = ((AUX_FAIL_RETRY, "fail_retry"),
              (AUX_FAIL_EXHAUSTED, "fail_exhausted"),
              (AUX_TIMEOUT, "timeout"))


def _aux_args(kind: int, aux: int) -> Dict[str, bool]:
    bits = _EXEC_BITS if kind == TraceKind.EXEC else _ARR_BITS
    return {name: True for bit, name in bits if aux & bit}


def events_to_trace(events: Dict[str, np.ndarray], *,
                    label: str = "repro") -> dict:
    """Build a Trace Event Format dict from one columnar stream."""
    out = []
    nodes = sorted(int(n) for n in np.unique(events["node"])
                   if n >= 0)
    for k in nodes:
        out.append(dict(ph="M", name="process_name", pid=k, tid=0,
                        args={"name": f"node {k}"}))
    kind, rid = events["kind"], events["rid"]
    fn, node = events["fn"], events["node"]
    aux, t, dt = events["aux"], events["t"], events["dt"]
    for i in range(len(kind)):
        k = int(kind[i])
        pid = max(int(node[i]), 0)
        tid = max(int(fn[i]), 0)
        args = dict(rid=int(rid[i]), fn=int(fn[i]),
                    qlen=int(events["qlen"][i]),
                    warm=int(events["warm"][i]),
                    **_aux_args(k, int(aux[i])))
        name = TraceKind.NAMES[k]
        if k == TraceKind.EXEC:
            ts = (t[i] - dt[i]) * _US
            out.append(dict(ph="X", name=f"exec fn{int(fn[i])}",
                            cat=name, ts=float(ts),
                            dur=float(dt[i] * _US), pid=pid, tid=tid,
                            args=args))
        elif k == TraceKind.CHURN:
            state = "up" if int(aux[i]) else "down"
            out.append(dict(ph="i", name=f"node {state}", cat=name,
                            ts=float(t[i] * _US), pid=pid, tid=0,
                            s="p", args={}))
        else:
            out.append(dict(ph="i", name=f"{name} rid{int(rid[i])}",
                            cat=name, ts=float(t[i] * _US), pid=pid,
                            tid=tid, s="t", args=args))
    return dict(traceEvents=out, displayTimeUnit="ms",
                otherData={"source": label})


def validate_trace(trace: dict) -> int:
    """Check Trace Event Format invariants; return the event count.

    Raises ``ValueError`` on the first violation — used by the test
    suite and the chip smoke as a schema round-trip check."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace: missing top-level 'traceEvents'")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("trace: 'traceEvents' is not a list")
    for i, e in enumerate(evs):
        for f in ("ph", "name", "pid", "tid"):
            if f not in e:
                raise ValueError(f"trace event {i}: missing {f!r}")
        ph = e["ph"]
        if ph not in ("X", "i", "M", "B", "E", "C"):
            raise ValueError(f"trace event {i}: bad ph {ph!r}")
        if ph != "M":
            if not isinstance(e.get("ts"), (int, float)):
                raise ValueError(f"trace event {i}: bad ts")
        if ph == "X":
            if not (isinstance(e.get("dur"), (int, float))
                    and e["dur"] >= 0):
                raise ValueError(f"trace event {i}: bad dur")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            raise ValueError(f"trace event {i}: bad instant scope")
    return len(evs)


def save_trace(events: Dict[str, np.ndarray], path, *,
               label: str = "repro",
               validate: bool = True) -> Optional[dict]:
    """Export one event stream as Perfetto-loadable JSON."""
    trace = events_to_trace(events, label=label)
    if validate:
        validate_trace(trace)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace


def load_trace(path) -> dict:
    with open(path) as fh:
        return json.load(fh)

"""Per-request span reassembly and the `TraceRun` container
(counterpart of `repro.telemetry.spans`).

A *span* is one request's lifecycle reassembled from the flat
per-event records of the trace rail (`repro_torch.telemetry.rail`):
arrival → (queued) → (cold start) → execution attempts → completion,
with retries, reroutes and deferred node arrivals as child instants.
`TraceRun` holds one event stream per computed grid cell, addressed by
the same labeled coordinates as the owning `ResultSet`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.rail import (AUX_COLD, AUX_FAIL_EXHAUSTED,
                                  AUX_FAIL_RETRY, AUX_QUEUED,
                                  AUX_SHED, TraceKind, _FIELDS_F,
                                  _FIELDS_I)

_FIELDS = _FIELDS_I + _FIELDS_F


@dataclass
class Span:
    """One request's reassembled lifecycle."""

    rid: int
    fn: int
    arrival: float                  # raw-arrival instant (ARRIVAL)
    node: int = -1                  # node of the final execution
    start: float = -1.0             # dispatch of the final execution
    completion: float = -1.0        # -1: shed / exhausted / unfinished
    queued: bool = False            # ever pushed onto a queue
    cold: bool = False              # dispatch began a cold start
    shed: bool = False              # terminally load-shed
    # every execution attempt: (t_start, t_end, node, aux)
    attempts: List[Tuple[float, float, int, int]] = field(
        default_factory=list)
    # routing child instants: (kind name, t, node)
    children: List[Tuple[str, float, int]] = field(
        default_factory=list)

    @property
    def response(self) -> float:
        return (self.completion - self.arrival
                if self.completion >= 0 else float("nan"))

    @property
    def n_attempts(self) -> int:
        return len(self.attempts)


def assemble_spans(events: Dict[str, np.ndarray]) -> Dict[int, Span]:
    """Reassemble one cell's columnar event stream into per-rid spans.

    The stream must be in event order (the rail's flush order). The
    returned dict is keyed by request id; requests that never complete
    (shed, retry-exhausted) keep ``completion == -1``."""
    spans: Dict[int, Span] = {}
    kind = events["kind"]
    rid = events["rid"]
    fn = events["fn"]
    node = events["node"]
    aux = events["aux"]
    t = events["t"]
    dt = events["dt"]
    for i in range(len(kind)):
        k, r = int(kind[i]), int(rid[i])
        if r < 0:
            continue
        if k == TraceKind.ARRIVAL:
            sp = spans.get(r)
            if sp is None:
                spans[r] = sp = Span(rid=r, fn=int(fn[i]),
                                     arrival=float(t[i]))
            if aux[i] & AUX_QUEUED:
                sp.queued = True
            if aux[i] & AUX_COLD:
                sp.cold = True
            if aux[i] & AUX_SHED:
                sp.shed = True
        elif k == TraceKind.EXEC:
            sp = spans.get(r)
            if sp is None:
                # stream window cut the arrival off: synthesise
                spans[r] = sp = Span(rid=r, fn=int(fn[i]),
                                     arrival=float(t[i] - dt[i]))
            a = int(aux[i])
            sp.attempts.append((float(t[i] - dt[i]), float(t[i]),
                                int(node[i]), a))
            if not a & (AUX_FAIL_RETRY | AUX_FAIL_EXHAUSTED):
                sp.completion = float(t[i])
                sp.start = float(t[i] - dt[i])
                sp.node = int(node[i])
        elif k in (TraceKind.RETRY, TraceKind.NODE_ARRIVAL,
                   TraceKind.REROUTE, TraceKind.TIMER):
            sp = spans.get(r)
            if sp is not None:
                sp.children.append((TraceKind.NAMES[k], float(t[i]),
                                    int(node[i])))
                if aux[i] & AUX_QUEUED:
                    sp.queued = True
                if aux[i] & AUX_COLD:
                    sp.cold = True
                if aux[i] & AUX_SHED:
                    sp.shed = True
    return spans


class TraceRun:
    """Per-grid-cell event streams of one traced experiment run.

    ``coords`` are the owning `ResultSet`'s labeled axes; ``cells``
    maps coordinate-index tuples (same axis order) to columnar event
    dicts. Selection mirrors `ResultSet.value`: every axis must
    resolve to exactly one entry (axes of length one resolve
    implicitly)."""

    def __init__(self, coords: Dict[str, list],
                 cells: Optional[Dict[tuple, dict]] = None):
        self.coords = {k: list(v) for k, v in coords.items()}
        self.cells: Dict[tuple, dict] = dict(cells or {})

    @property
    def dims(self) -> Tuple[str, ...]:
        return tuple(self.coords)

    def add_cell(self, key: tuple, events: dict) -> None:
        self.cells[tuple(key)] = events

    def _cell_key(self, **sel) -> tuple:
        unknown = set(sel) - set(self.coords)
        if unknown:
            raise KeyError(f"TraceRun: unknown dim(s) "
                           f"{sorted(unknown)}; dims are {self.dims}")
        key = []
        for d, values in self.coords.items():
            if d in sel:
                want = sel[d]
                matches = [i for i, v in enumerate(values)
                           if v == want or (
                               isinstance(v, float)
                               and isinstance(want, (int, float))
                               and float(v) == float(want))]
                if len(matches) != 1:
                    raise KeyError(
                        f"TraceRun: {d}={want!r} matches "
                        f"{len(matches)} of {values}")
                key.append(matches[0])
            elif len(values) == 1:
                key.append(0)
            else:
                raise KeyError(
                    f"TraceRun: dim {d!r} has {len(values)} entries "
                    f"{values} — select one")
        return tuple(key)

    def events(self, **sel) -> Dict[str, np.ndarray]:
        """The selected cell's columnar event arrays."""
        key = self._cell_key(**sel)
        try:
            return self.cells[key]
        except KeyError:
            raise KeyError(
                f"TraceRun: cell {key} was not computed "
                f"({len(self.cells)} cells held)") from None

    def spans(self, **sel) -> Dict[int, Span]:
        return assemble_spans(self.events(**sel))

    @property
    def n_events(self) -> int:
        return sum(len(ev["kind"]) for ev in self.cells.values())

    # -------------------------------------------------------- npz io
    def save_npz(self, path) -> None:
        """Columnar npz export: one array per (cell, field), plus a
        json index of coords and cell keys."""
        import json
        payload = {}
        keys = sorted(self.cells)
        for ci, key in enumerate(keys):
            for f in _FIELDS:
                payload[f"c{ci}_{f}"] = self.cells[key][f]
        header = dict(coords=self.coords,
                      keys=[list(k) for k in keys])
        payload["index_json"] = np.frombuffer(
            json.dumps(header).encode(), np.uint8)
        np.savez_compressed(path, **payload)

    @staticmethod
    def load_npz(path) -> "TraceRun":
        import json
        with np.load(path) as z:
            header = json.loads(bytes(z["index_json"]).decode())
            cells = {}
            for ci, key in enumerate(header["keys"]):
                cells[tuple(key)] = {f: z[f"c{ci}_{f}"]
                                     for f in _FIELDS}
        return TraceRun(header["coords"], cells)

    def __repr__(self):
        axes = ", ".join(f"{d}={len(v)}"
                         for d, v in self.coords.items())
        return (f"TraceRun({axes}; {len(self.cells)} cells, "
                f"{self.n_events} events)")

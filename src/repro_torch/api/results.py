"""Labeled experiment results: the `ResultSet`.

Counterpart of `repro.api.results`. Every metric array carries the grid
axes ``(policy, trace, capacity, beta)`` in that order, plus a trailing
``cluster`` axis when the producing spec declared one (its coords are
the `ClusterSpec` labels); metric-specific dims (histogram and timeline
bins, per-function deadline misses, per-node counts, per-request N)
follow.
Selection (`sel` / `value`), tidy rows (`rows`), CSV (`to_csv`), an npz
round-trip (`save_npz` / `load_npz`) and the join of host shards
(`merge`) work as in the JAX package: a run with ``host_shard`` computes
part of the grid, ``computed`` marks that part, and every reader but
`merge` skips or refuses the rest. A run
with ``trace_events`` attaches its per-cell event streams (``trace``, a
`repro_torch.telemetry.TraceRun`, exported on its own with
``trace.save_npz``) and `timeline` bins one cell's stream.
"""
from __future__ import annotations

import csv
import json
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

DIMS = ("policy", "trace", "capacity", "beta")
CLUSTER_DIM = "cluster"     # optional trailing axis of cluster runs

# metrics that must be zero on every computed cell for a valid run
HEALTH_METRICS = ("overflow", "stalled")


@dataclass
class ResultSet:
    """Metric arrays over the labeled experiment grid."""

    data: Dict[str, np.ndarray]
    coords: Dict[str, list]
    computed: Optional[np.ndarray] = None    # (P, T, K, B) bool
    meta: dict = field(default_factory=dict)
    # per-cell event streams of a trace_events=True run
    # (`repro_torch.telemetry.TraceRun`); not part of the npz payload --
    # export separately with `trace.save_npz`
    trace: Optional[object] = None

    def __post_init__(self):
        shape = self.grid_shape
        if self.computed is None:
            self.computed = np.ones(shape, bool)
        for k, v in self.data.items():
            if tuple(v.shape[:len(shape)]) != shape:
                raise ValueError(
                    f"ResultSet: metric {k!r} shape {v.shape} does not "
                    f"lead with the grid shape {shape}")

    @property
    def dims(self):
        """Grid axis names: the four core dims, plus ``cluster`` when the
        producing spec declared a cluster axis."""
        return (DIMS + (CLUSTER_DIM,) if CLUSTER_DIM in self.coords
                else DIMS)

    @property
    def grid_shape(self):
        return tuple(len(self.coords[d]) for d in self.dims)

    @property
    def metrics(self) -> List[str]:
        return sorted(self.data)

    def __getitem__(self, metric: str) -> np.ndarray:
        try:
            return self.data[metric]
        except KeyError:
            raise KeyError(f"ResultSet: no metric {metric!r}; have "
                           f"{self.metrics}") from None

    # -------------------------------------------------------- selection
    def _axis_indices(self, dim: str, want) -> List[int]:
        values = self.coords[dim]
        singular = not isinstance(want, (list, tuple, np.ndarray))
        wants = [want] if singular else list(want)
        idx = []
        for w in wants:
            matches = [i for i, v in enumerate(values)
                       if v == w or (isinstance(v, float)
                                     and isinstance(w, (int, float))
                                     and float(v) == float(w))]
            if not matches:
                raise KeyError(
                    f"ResultSet.sel: {dim}={w!r} not on the {dim} axis "
                    f"{values}")
            if singular and len(matches) > 1:
                raise KeyError(
                    f"ResultSet.sel: {dim}={w!r} is ambiguous "
                    f"({len(matches)} axis entries match) -- pass a "
                    "list to select all of them")
            idx.extend(matches)
        return idx

    def sel(self, **which) -> "ResultSet":
        """Subset by coordinate *value* (scalar or list per dim), e.g.
        ``rs.sel(policy="esff", capacity=[8, 16])``. Axes are retained
        (scalar selections become size-1); use `value` for one cell."""
        dims = self.dims
        unknown = set(which) - set(dims)
        if unknown:
            raise KeyError(f"ResultSet.sel: unknown dim(s) "
                           f"{sorted(unknown)}; dims are {dims}")
        coords = dict(self.coords)
        data = dict(self.data)
        comp = self.computed
        for d, want in which.items():
            ax = dims.index(d)
            ids = self._axis_indices(d, want)
            coords[d] = [self.coords[d][i] for i in ids]
            data = {k: np.take(v, ids, axis=ax) for k, v in data.items()}
            comp = np.take(comp, ids, axis=ax)
        return ResultSet(data=data, coords=coords, computed=comp,
                         meta=dict(self.meta))

    def value(self, metric: str, **which):
        """The one cell of ``metric`` selected by ``which``: a python
        scalar for scalar metrics, an ndarray for metrics with trailing
        dims (``resp_hist``, ``response``)."""
        sub = self.sel(**which) if which else self
        nd = len(sub.dims)
        if sub.grid_shape != (1,) * nd:
            raise KeyError(
                f"ResultSet.value({metric!r}): selection leaves grid "
                f"{dict(zip(sub.dims, sub.grid_shape))}, need exactly one "
                "cell -- add coords")
        if not sub.computed.reshape(-1)[0]:
            raise ValueError(
                f"ResultSet.value({metric!r}): cell not computed (this "
                "is a host shard -- merge() the other shards first)")
        cell = sub[metric][(0,) * nd]
        return cell.item() if np.ndim(cell) == 0 else np.asarray(cell)

    # -------------------------------------------------------- telemetry
    def timeline(self, bucket: float = 60.0, *, deadlines=None,
                 **sel) -> Dict[str, np.ndarray]:
        """Streaming per-bin time series of one traced grid cell.

        Requires a run with ``trace_events=True`` (the attached
        `repro_torch.telemetry.TraceRun`). ``sel`` selects one cell
        exactly like `value` (axes of length one resolve implicitly);
        returns the `repro_torch.telemetry.metrics.timeline` dict --
        per-node queue depth, warm occupancy, utilization, throughput,
        goodput and SLO attainment per ``bucket``-second bin.
        ``deadlines`` defaults to the producing spec's (from ``meta``)."""
        if self.trace is None:
            raise ValueError(
                "ResultSet.timeline: no event streams attached -- run "
                "with ExperimentSpec(trace_events=True)")
        from repro_torch.telemetry import metrics as _tmet
        ev = self.trace.events(**sel)
        key = self.trace._cell_key(**sel)
        tr_coords = self.trace.coords
        cap = None
        if "capacity" in tr_coords:
            c = tr_coords["capacity"][
                key[list(tr_coords).index("capacity")]]
            if isinstance(c, (int, np.integer)):
                cap = int(c)
        if deadlines is None:
            deadlines = self.meta.get("deadlines")
        return _tmet.timeline(ev, bucket=bucket, capacity=cap,
                              deadlines=deadlines)

    # ------------------------------------------------------- tidy rows
    def rows(self, metrics: Optional[Sequence[str]] = None
             ) -> Iterator[dict]:
        """One dict per computed grid cell with every coordinate and
        every scalar metric (vector metrics only when named)."""
        dims = self.dims
        names = list(metrics) if metrics is not None else [
            m for m in self.metrics if self.data[m].ndim == len(dims)]
        for cell_ix in np.ndindex(*self.grid_shape):
            if not self.computed[cell_ix]:
                continue
            row = {d: self.coords[d][i] for d, i in zip(dims, cell_ix)}
            for m in names:
                cell = self.data[m][cell_ix]
                row[m] = (cell.item() if np.ndim(cell) == 0
                          else np.asarray(cell))
            yield row

    def to_csv(self, out=None,
               metrics: Optional[Sequence[str]] = None) -> str:
        """Write the tidy rows as CSV to ``out`` (path, file object, or
        None for stdout); returns the header line."""
        rows = list(self.rows(metrics))
        if not rows:
            raise ValueError("ResultSet.to_csv: no computed cells")
        header = list(rows[0].keys())

        def _write(fh):
            w = csv.DictWriter(fh, fieldnames=header)
            w.writeheader()
            for r in rows:
                w.writerow({k: (f"{v:.6g}" if isinstance(v, float)
                                else v) for k, v in r.items()})
        if out is None:
            _write(sys.stdout)
        elif isinstance(out, (str, bytes)) or hasattr(out, "__fspath__"):
            with open(out, "w", newline="") as fh:
                _write(fh)
        else:
            _write(out)
        return ",".join(header)

    # ----------------------------------------------------------- health
    def _bad_cells(self, bad: np.ndarray, limit: int = 8) -> str:
        cells = np.argwhere(bad)[:limit]
        named = "; ".join(
            ", ".join(f"{d}={self.coords[d][i]!r}"
                      for d, i in zip(self.dims, c)) for c in cells)
        more = int(bad.sum()) - len(cells)
        return named + (f"; ... {more} more" if more > 0 else "")

    def check(self) -> "ResultSet":
        """Raise if any computed cell is invalid; returns self.

        Invalid is: nonzero ``overflow`` (a queue overran with shedding
        disabled: requests were dropped; a shed under
        ``on_overflow="shed"`` / ``"shed_oldest"`` is counted in ``shed``
        by design), nonzero ``stalled`` (the event loop ran out of events
        or iterations before draining) or, on a run with faults, a broken
        conservation ``done + shed + failed_exhausted != n_requests``.
        Each error names the cells by their coordinates."""
        for m in HEALTH_METRICS:
            if m not in self.data:
                continue
            bad = (self.data[m] != 0) & self.computed
            if not bad.any():
                continue
            if m == "overflow":
                hint = ("queue overran with shedding disabled -- requests "
                        "were dropped. Raise queue_cap, or opt into load "
                        "shedding with ExperimentSpec(on_overflow=\"shed\" "
                        "/ \"shed_oldest\") to count drops as `shed` by "
                        "design")
            else:
                hint = ("event loop hit its iteration cap or ran out of "
                        "events before draining -- engine invariant "
                        "violation")
            raise RuntimeError(
                f"ResultSet.check: {int(bad.sum())} cell(s) with nonzero "
                f"{m!r} ({hint}): {self._bad_cells(bad)}")
        need = ("done", "shed", "failed_exhausted")
        if (self.meta.get("resilience") and "n_requests" in self.meta
                and all(k in self.data for k in need)):
            n = int(self.meta["n_requests"])
            tot = sum(self.data[k].astype(np.int64) for k in need)
            bad = (tot != n) & self.computed
            if bad.any():
                raise RuntimeError(
                    f"ResultSet.check: {int(bad.sum())} cell(s) break "
                    f"conservation (done + shed + failed_exhausted != "
                    f"n_requests={n}): {self._bad_cells(bad)}")
        return self

    # -------------------------------------------------------- npz io
    def save_npz(self, path) -> None:
        payload = {f"m_{k}": v for k, v in self.data.items()}
        payload["computed"] = self.computed
        payload["coords_json"] = np.frombuffer(
            json.dumps(self.coords).encode(), np.uint8)
        payload["meta_json"] = np.frombuffer(
            json.dumps(self.meta, default=str).encode(), np.uint8)
        np.savez_compressed(path, **payload)

    @staticmethod
    def load_npz(path) -> "ResultSet":
        with np.load(path) as z:
            data = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
            coords = json.loads(bytes(z["coords_json"]).decode())
            meta = json.loads(bytes(z["meta_json"]).decode())
            computed = np.asarray(z["computed"], bool)
        return ResultSet(data=data, coords=coords, computed=computed,
                         meta=meta)

    # ----------------------------------------------------------- merge
    def merge(self, *others: "ResultSet") -> "ResultSet":
        """Join host-sharded parts of one grid: the parts must share
        coords and metric sets, and each cell must be computed by at most
        one of them (``host_shard`` partitions the chunks so). Returns a
        new ResultSet whose ``computed`` mask is the union."""
        merged = ResultSet(
            data={k: v.copy() for k, v in self.data.items()},
            coords={k: list(v) for k, v in self.coords.items()},
            computed=self.computed.copy(), meta=dict(self.meta))
        for o in others:
            if o.coords != merged.coords:
                raise ValueError("ResultSet.merge: coords differ -- "
                                 "shards must come from the same spec")
            if set(o.data) != set(merged.data):
                raise ValueError(
                    f"ResultSet.merge: metric sets differ "
                    f"({sorted(set(o.data) ^ set(merged.data))})")
            overlap = merged.computed & o.computed
            if overlap.any():
                raise ValueError(
                    f"ResultSet.merge: {int(overlap.sum())} cell(s) "
                    "computed by more than one shard")
            take = o.computed
            for k in merged.data:
                merged.data[k][take] = o.data[k][take]
            merged.computed |= take
        return merged

    def __repr__(self):
        axes = ", ".join(f"{d}={n}"
                         for d, n in zip(self.dims, self.grid_shape))
        return (f"ResultSet({axes}; {int(self.computed.sum())}/"
                f"{int(np.prod(self.grid_shape))} cells, "
                f"metrics={self.metrics})")

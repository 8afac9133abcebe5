"""Request / function / trace data model (paper §III-A).

All times are float seconds. A :class:`Request` ``r_i`` carries its arrival
time ``t_i^a`` and (ground-truth) execution time ``t_i^e``; the scheduler
never reads ``exec_time`` directly — it sees it only once the request
completes (the simulator feeds completions back into the per-function
running-mean estimators, §V).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class FunctionProfile:
    """Static, platform-known properties of a serverless function f_j.

    ``cold_start`` is t_j^l and ``evict`` is t_j^v — both are platform
    properties (image pull + runtime init / teardown) and are known to the
    scheduler, matching the paper's setup where they are sampled once per
    function from U[0.5, 1.5] s.
    """

    fn_id: int
    cold_start: float
    evict: float
    # Ground-truth mean execution time; used only by trace generators and
    # by the oracle estimator mode, never by the online scheduler.
    true_mean_exec: float = 0.0
    name: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"f{self.fn_id}"


@dataclass
class Request:
    """A single invocation r_i of function ``fn_id`` (= l_i)."""

    req_id: int
    fn_id: int
    arrival: float          # t_i^a
    exec_time: float        # t_i^e  (ground truth; hidden from scheduler)
    # Filled in by the simulator:
    start: float = -1.0     # t_i^s
    completion: float = -1.0  # t_i^c

    @property
    def response(self) -> float:
        """t_i^r = t_i^c - t_i^a (execution + waiting [+ cold start])."""
        return self.completion - self.arrival

    @property
    def slowdown(self) -> float:
        return self.response / max(self.exec_time, 1e-9)

    @property
    def done(self) -> bool:
        return self.completion >= 0.0


@dataclass
class Trace:
    """An ordered request stream plus the function catalogue."""

    functions: List[FunctionProfile]
    requests: List[Request]
    meta: dict = field(default_factory=dict)
    # memoized to_arrays() view (not part of the value: excluded from
    # comparison/repr)
    _arrays: Optional[dict] = field(default=None, repr=False,
                                    compare=False)

    def __post_init__(self) -> None:
        self.requests.sort(key=lambda r: (r.arrival, r.req_id))

    @property
    def n_functions(self) -> int:
        return len(self.functions)

    def __len__(self) -> int:
        return len(self.requests)

    def scaled(self, intensity_ratio: float) -> "Trace":
        """Scale inter-arrival intervals by ``intensity_ratio`` (paper Fig. 6).

        Ratio > 1 stretches intervals (lighter load); < 1 compresses them.
        Execution times are untouched.
        """
        reqs = [
            Request(r.req_id, r.fn_id, r.arrival * intensity_ratio, r.exec_time)
            for r in self.requests
        ]
        meta = dict(self.meta, intensity_ratio=intensity_ratio)
        return Trace(self.functions, reqs, meta)

    def head(self, n: int) -> "Trace":
        reqs = [Request(r.req_id, r.fn_id, r.arrival, r.exec_time)
                for r in self.requests[:n]]
        return Trace(self.functions, reqs, dict(self.meta, head=n))

    # ------------------------------------------------------------------ io
    def to_arrays(self):
        """Columnar view (used by the lane-batched engine and npz io).

        Memoized: the exported columns (ids, arrivals, exec/cold/evict
        times) are immutable for a Trace's lifetime — the simulator
        only ever mutates per-request ``start``/``completion``, which
        are not part of the view — and re-walking 10^4+ Request objects
        per ``sweep`` call is pure-Python overhead the vectorised
        engine would otherwise pay on every repeat sweep."""
        if self._arrays is None:
            n = len(self.requests)
            fn = np.empty(n, np.int32)
            arr = np.empty(n, np.float64)
            ex = np.empty(n, np.float64)
            for i, r in enumerate(self.requests):
                fn[i], arr[i], ex[i] = r.fn_id, r.arrival, r.exec_time
            cold = np.array([f.cold_start for f in self.functions],
                            np.float64)
            evict = np.array([f.evict for f in self.functions],
                             np.float64)
            self._arrays = dict(fn_id=fn, arrival=arr, exec_time=ex,
                                cold_start=cold, evict=evict)
            for v in self._arrays.values():
                v.setflags(write=False)   # shared across calls
        return dict(self._arrays)

    @staticmethod
    def from_arrays(a: dict, meta: Optional[dict] = None) -> "Trace":
        funcs = [
            FunctionProfile(j, float(c), float(v))
            for j, (c, v) in enumerate(zip(a["cold_start"], a["evict"]))
        ]
        reqs = [
            Request(i, int(f), float(t), float(e))
            for i, (f, t, e) in enumerate(
                zip(a["fn_id"], a["arrival"], a["exec_time"]))
        ]
        return Trace(funcs, reqs, meta or {})

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, **self.to_arrays())

    @staticmethod
    def load_npz(path: str) -> "Trace":
        with np.load(path) as z:
            return Trace.from_arrays({k: z[k] for k in z.files},
                                     {"source": path})

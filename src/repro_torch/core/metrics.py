"""Evaluation metrics (paper §VI-A): mean response time, mean slowdown,
cold-start accounting, CDFs/percentiles and per-minute timelines (Fig. 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.server import ServerStats


@dataclass
class SimResult:
    policy: str
    capacity: int
    responses: np.ndarray          # t^c - t^a per request
    slowdowns: np.ndarray          # response / exec
    exec_times: np.ndarray
    arrivals: np.ndarray
    server: ServerStats
    wall_seconds: float = 0.0
    meta: dict = field(default_factory=dict)

    # ------------------------------------------------------------ scalars
    @property
    def mean_response(self) -> float:
        return float(self.responses.mean())

    @property
    def mean_slowdown(self) -> float:
        return float(self.slowdowns.mean())

    @property
    def cold_starts(self) -> int:
        return self.server.cold_starts

    @property
    def cold_time_per_request(self) -> float:
        return self.server.cold_time / max(len(self.responses), 1)

    def percentile(self, q: float, what: str = "responses") -> float:
        return float(np.percentile(getattr(self, what), q))

    # ---------------------------------------------------------------- cdf
    def cdf(self, what: str = "responses", points: int = 200):
        x = np.sort(getattr(self, what))
        idx = np.linspace(0, len(x) - 1, points).astype(int)
        return x[idx], (idx + 1) / len(x)

    def timeline(self, bucket: float = 60.0) -> Dict[str, np.ndarray]:
        """Per-minute aggregates over arrival time (Fig. 8)."""
        b = (self.arrivals // bucket).astype(int)
        n = b.max() + 1 if len(b) else 0
        counts = np.bincount(b, minlength=n)
        resp = np.bincount(b, weights=self.responses, minlength=n)
        ex = np.bincount(b, weights=self.exec_times, minlength=n)
        safe = np.maximum(counts, 1)
        return dict(minute=np.arange(n), n_requests=counts,
                    mean_response=resp / safe, mean_exec=ex / safe)

    def summary(self) -> dict:
        return dict(
            policy=self.policy,
            capacity=self.capacity,
            n_requests=len(self.responses),
            mean_response=self.mean_response,
            mean_slowdown=self.mean_slowdown,
            p95_response=self.percentile(95),
            p99_response=self.percentile(99),
            cold_starts=self.server.cold_starts,
            cold_time=self.server.cold_time,
            evictions=self.server.evictions,
            cold_time_per_request=self.cold_time_per_request,
            wall_seconds=self.wall_seconds,
        )


def collect(policy: str, capacity: int, requests: List[Request],
            stats: ServerStats, wall: float, meta: dict) -> SimResult:
    done = [r for r in requests if r.done]
    if len(done) != len(requests):
        raise RuntimeError(
            f"{policy}: {len(requests) - len(done)} requests never completed"
        )
    return SimResult(
        policy=policy,
        capacity=capacity,
        responses=np.array([r.response for r in done]),
        slowdowns=np.array([r.slowdown for r in done]),
        exec_times=np.array([r.exec_time for r in done]),
        arrivals=np.array([r.arrival for r in done]),
        server=stats,
        wall_seconds=wall,
        meta=meta,
    )

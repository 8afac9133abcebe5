"""SSFS: the simplified offline problem and its optimal algorithm
(paper §IV). A copy of `repro.core.ssfs` (pure Python).

Setting (the paper's simplifications S1-S4): a unary edge server (one
resident instance), a deterministic execution time t_j per function,
every request present at time 0, and full knowledge of (n_j, t_j,
t_j^l, t_j^v).

Cost model: starting a batch of function f_j costs its own setup
``s_j = t_j^l + t_j^v`` (the paper's exchange arguments, Eqs. (2)-(5),
attribute each function's eviction to itself), after which its n_j
requests run back to back.

Theorem 2: processing functions contiguously in ascending order of

    w_j = t_j + (t_j^l + t_j^v) / n_j

minimises the total (= average) response time: a weighted-SPT rule over
function batches (batch duration D_j = s_j + n_j t_j, order ascending
D_j / n_j = w_j).

``brute_force_best`` enumerates *all* request orderings (setup paid at
every function switch) and certifies optimality on small instances.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class SSFSFunction:
    """One function family in the SSFS instance."""

    fn_id: int
    n: int            # n_j: number of requests (all arrive at t = 0)
    exec: float       # t_j: per-request execution time
    cold: float       # t_j^l
    evict: float      # t_j^v

    @property
    def setup(self) -> float:
        return self.cold + self.evict

    @property
    def weight(self) -> float:
        """w_j = t_j + (t_j^l + t_j^v) / n_j."""
        return self.exec + self.setup / self.n


def ssfs_schedule(functions: Sequence[SSFSFunction]
                  ) -> Tuple[List[int], float]:
    """Optimal SSFS schedule: (function order by ascending weight, total
    response time)."""
    order = sorted(functions, key=lambda f: (f.weight, f.fn_id))
    total, clock = 0.0, 0.0
    for f in order:
        clock += f.setup
        for _ in range(f.n):
            clock += f.exec
            total += clock          # arrival is 0, so response = clock
    return [f.fn_id for f in order], total


def sequence_cost(functions: Sequence[SSFSFunction],
                  request_seq: Sequence[int]) -> float:
    """Total response time of an arbitrary request-level sequence:
    ``request_seq`` lists the function id of each processed request, and
    the setup s_j is paid whenever the function differs from the previous
    request's (and for the very first request)."""
    by_id = {f.fn_id: f for f in functions}
    total, clock, prev = 0.0, 0.0, None
    for fid in request_seq:
        f = by_id[fid]
        if fid != prev:
            clock += f.setup
            prev = fid
        clock += f.exec
        total += clock
    return total


def brute_force_best(functions: Sequence[SSFSFunction]
                     ) -> Tuple[Tuple[int, ...], float]:
    """Exhaustive minimum over all distinct request orderings (small
    instances only: n!)."""
    pool: List[int] = []
    for f in functions:
        pool.extend([f.fn_id] * f.n)
    best_seq, best = None, float("inf")
    for perm in set(itertools.permutations(pool)):
        c = sequence_cost(functions, perm)
        if c < best:
            best_seq, best = perm, c
    return best_seq, best

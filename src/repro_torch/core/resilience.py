"""Request-level resilience: failure injection, timeouts, retry backoff
(counterpart of `repro.core.resilience`).

Every stochastic choice is made outside the engines, from counter-hash
draws keyed on the request id (its position in the original trace) and
the attempt number, so a request fails, times out and backs off alike on
every tier and device:

* `plan_outcomes` pre-computes, per request, the execution time an
  attempt spends (``min(exec, timeout)``), the number of leading failed
  attempts ``n_fail`` (attempt ``a`` fails iff ``a <= n_fail``) and
  whether a failure is a timeout (a timed-out request fails on every
  attempt, so its ``n_fail`` is ``max_attempts``);
* `backoff_py` / `backoff_torch` give the capped exponential backoff
  after a failed attempt, with deterministic jitter from the same
  ``(rid, attempt)`` hash stream; the two are bitwise equal on f64.

The engines then only test ``attempt > n_fail[rid]`` at an attempt's
completion.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.cluster.routers import _M32, mix32_np, mix32_py, mix32_torch

# xor-ed into the failure seed for the jitter stream, so that jitter
# draws never correlate with the fail draws
JITTER_SALT = 0x5BF03635

# the attempt counter rides the low 4 bits of the hash key
MAX_ATTEMPTS = 16

SHED_MODES = {"error": 0, "shed": 1, "shed_oldest": 2}


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: a failed attempt ``a`` (1-based)
    re-enters after ``min(base * 2**(a-1), cap)`` seconds, scaled by a
    deterministic jitter factor in ``[1 - jitter, 1 + jitter)``."""

    max_attempts: int = 3
    base: float = 1.0
    cap: float = 30.0
    jitter: float = 0.0

    def __post_init__(self) -> None:
        if not (1 <= int(self.max_attempts) <= MAX_ATTEMPTS):
            raise ValueError(
                f"RetryPolicy.max_attempts must be in [1, {MAX_ATTEMPTS}], "
                f"got {self.max_attempts}")
        if self.base < 0 or self.cap < 0:
            raise ValueError("RetryPolicy.base and cap must be >= 0")
        if not (0.0 <= float(self.jitter) < 1.0):
            raise ValueError("RetryPolicy.jitter must be in [0, 1)")

    def as_tuple(self) -> tuple:
        return (int(self.max_attempts), float(self.base), float(self.cap),
                float(self.jitter))


def per_fn(value, n_fns: int, name: str, dtype=np.float64) -> np.ndarray:
    """Broadcast a scalar, or check a per-function sequence."""
    if np.isscalar(value):
        return np.full(n_fns, value, dtype=dtype)
    arr = np.asarray(value, dtype=dtype)
    if arr.shape != (n_fns,):
        raise ValueError(
            f"{name} must be a scalar or a length-{n_fns} sequence, "
            f"got shape {arr.shape}")
    return arr


def plan_outcomes(fn_id: np.ndarray, exec_time: np.ndarray, *,
                  fail_prob: Union[float, Sequence[float]],
                  timeouts: Optional[Union[float, Sequence[float]]],
                  max_attempts: int, n_fns: int, seed: int,
                  rid: Optional[np.ndarray] = None):
    """Per-request outcomes ``(eff_exec, n_fail, is_tmo)``: the f64 time
    an attempt runs (``min(exec, timeout[fn])``), the i32 count of leading
    failed attempts (``max_attempts`` exhausts the budget) and whether the
    failures are timeouts. ``rid`` (default ``arange(N)``) are the
    requests' original trace ids, so that a sliced view draws as the
    whole trace does."""
    fn_id = np.asarray(fn_id, dtype=np.int64)
    exec_time = np.asarray(exec_time, dtype=np.float64)
    n = fn_id.shape[0]
    rid = (np.arange(n, dtype=np.int64) if rid is None
           else np.asarray(rid, dtype=np.int64))
    a = int(max_attempts)
    if not (1 <= a <= MAX_ATTEMPTS):
        raise ValueError(f"max_attempts must be in [1, {MAX_ATTEMPTS}]")
    p = per_fn(fail_prob, n_fns, "fail_prob")
    if np.any((p < 0) | (p > 1)):
        raise ValueError("fail_prob must be in [0, 1]")
    thresh = p[fn_id] * 4294967296.0
    # u[i, j]: the 32-bit draw of attempt j + 1 of request rid[i]
    keys = (rid[:, None] << 4) | np.arange(a, dtype=np.int64)[None, :]
    u = mix32_np(keys, seed).astype(np.float64)
    fail_a = u < thresh[:, None]
    # the leading run of failures
    n_fail = np.cumprod(fail_a, axis=1).sum(axis=1).astype(np.int32)
    if timeouts is not None:
        budget = per_fn(timeouts, n_fns, "timeouts")
        if np.any(budget <= 0):
            raise ValueError("timeouts must be > 0")
        b = budget[fn_id]
        is_tmo = exec_time > b
        eff_exec = np.minimum(exec_time, b)
        # every attempt of a timed-out request burns the budget and dies
        n_fail = np.where(is_tmo, np.int32(a), n_fail)
    else:
        is_tmo = np.zeros(n, dtype=bool)
        eff_exec = exec_time
    return eff_exec, n_fail.astype(np.int32), is_tmo


def backoff_py(attempt: int, key: int, base: float, cap: float,
               jitter: float, seed: int) -> float:
    """Backoff after failed attempt ``attempt`` (1-based) of the request
    with original id ``key``; bitwise `backoff_torch`."""
    d = min(base * 2.0 ** (attempt - 1), cap)
    u = mix32_py((int(key) << 4) | ((attempt - 1) & 15),
                 seed ^ JITTER_SALT) / 4294967296.0
    return d * (1.0 + jitter * (2.0 * u - 1.0))


def backoff_torch(attempt, key, base: float, cap: float, jitter: float,
                  seed: int):
    """`backoff_py` elementwise over integer tensors ``attempt`` and
    ``key``, f64. The power of two is an exact integer shift (an
    ``exp2`` may be an ulp off)."""
    a1 = attempt.to(torch.int64) - 1
    pow2 = torch.bitwise_left_shift(torch.ones_like(a1), a1).to(
        torch.float64)
    d = torch.clamp_max(base * pow2, cap)
    k = ((key.to(torch.int64) & _M32) << 4 | (a1 & 15)) & _M32
    u = mix32_torch(k, torch.full_like(k, seed ^ JITTER_SALT)).to(
        torch.float64) / 4294967296.0
    return d * (1.0 + jitter * (2.0 * u - 1.0))

"""Synthetic serverless request traces (numpy; the same arrays as
`repro.traces.generator` for the same seed).

The paper evaluates on the Azure Functions 2021 trace [Zhang et al.,
SOSP'21] (2.2e6 requests / two weeks; first 6e5 used). That trace is not
redistributable inside this offline container, so ``synth_azure_trace``
generates a stream with the same published coarse statistics:

* function popularity ~ Zipf (a few functions dominate invocations),
* execution times ~ heavy-tailed log-normal across functions (ms .. min),
  quantised to 1 ms with the paper's "0 ms -> 1 ms" floor,
* arrivals: per-function Poisson thinned by a diurnal profile plus
  random burst windows (edge workloads are bursty, §II),
* cold-start / eviction latencies ~ U[0.5, 1.5] s (paper §VI-A, from
  ServerlessBench characterisation).

Everything is seeded and parameterised; benchmarks state their exact
parameters so results are reproducible. ``synth_azure_arrays`` is the
columnar fast path: the same sampler, but the result stays in (sorted)
numpy arrays — at 10^6 requests the ``Request``-object representation
costs hundreds of MB and seconds of pure-Python loops that the
vectorised engine never needs (benchmarks/engine_scale.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.request import FunctionProfile, Request, Trace


def trace_from_lists(fn_ids: Sequence[int], arrivals: Sequence[float],
                     exec_times: Sequence[float],
                     cold: Sequence[float], evict: Sequence[float],
                     names: Optional[Sequence[str]] = None) -> Trace:
    """Build a fully explicit trace (used by unit tests / paper figures)."""
    functions = [
        FunctionProfile(j, float(c), float(v),
                        name=(names[j] if names else ""))
        for j, (c, v) in enumerate(zip(cold, evict))
    ]
    reqs = [
        Request(i, int(f), float(a), float(e))
        for i, (f, a, e) in enumerate(zip(fn_ids, arrivals, exec_times))
    ]
    # record ground-truth means for oracle mode
    for f in functions:
        mine = [r.exec_time for r in reqs if r.fn_id == f.fn_id]
        f.true_mean_exec = float(np.mean(mine)) if mine else 0.0
    return Trace(functions, reqs)


def _sample_azure(
    n_functions: int,
    n_requests: int,
    *,
    utilization: float,
    capacity_ref: int,
    zipf_a: float,
    exec_median: float,
    exec_sigma: float,
    jitter_sigma: float,
    cold_range: tuple,
    burst_frac: float,
    diurnal_amp: float,
    seed: int,
    n_bursts_per_fn: int = 3,   # legacy knob, accepted and unused
):
    """Shared sampler: unsorted request columns + function catalogue."""
    rng = np.random.default_rng(seed)

    # --- function catalogue ------------------------------------------------
    pop = 1.0 / np.arange(1, n_functions + 1) ** zipf_a
    pop /= pop.sum()
    base_exec = np.exp(rng.normal(np.log(exec_median), exec_sigma,
                                  n_functions))
    base_exec = np.clip(base_exec, 1e-3, 120.0)
    cold = rng.uniform(*cold_range, n_functions)
    evict = rng.uniform(*cold_range, n_functions)

    counts = rng.multinomial(n_requests, pop)

    # --- duration from target utilisation ----------------------------------
    total_exec = float((counts * base_exec).sum())
    duration = total_exec / (utilization * capacity_ref)

    # Arrival model matching the Azure trace's granularity: per-minute
    # invocation counts per function. Minute rates follow a log-normal
    # multiplicative burst process on top of a diurnal profile — bursty
    # across minutes (the paper's §II "request bursts"), Poisson within.
    day = 86_400.0
    n_min = max(int(np.ceil(duration / 60.0)), 1)
    minute_t = (np.arange(n_min) + 0.5) * 60.0
    fn_col, arr_col, exe_col = [], [], []
    for j in range(n_functions):
        n_j = int(counts[j])
        if n_j == 0:
            continue
        phase = rng.uniform(0, 2 * np.pi)
        diurnal = 1 + diurnal_amp * np.sin(2 * np.pi * minute_t / day + phase)
        # burst multiplier: most minutes ~quiet, a few minutes hot.
        sigma_b = np.log(10.0) * burst_frac * 2  # burst_frac .3 -> x10 tail
        bursts = np.exp(rng.normal(0, sigma_b, n_min))
        weights = np.clip(diurnal, 0.05, None) * bursts
        weights /= weights.sum()
        per_min = rng.multinomial(n_j, weights)
        nz = np.nonzero(per_min)[0]
        t = np.concatenate([
            (m + rng.uniform(0, 1, per_min[m])) * 60.0 for m in nz
        ]) if len(nz) else np.empty(0)
        ex = base_exec[j] * np.exp(rng.normal(0, jitter_sigma, n_j))
        ex = np.maximum(np.round(ex, 3), 1e-3)   # 1 ms quantisation + floor
        fn_col.append(np.full(n_j, j, np.int32))
        arr_col.append(t)
        exe_col.append(ex)

    fn_ids = np.concatenate(fn_col)
    arrivals = np.concatenate(arr_col)
    execs = np.concatenate(exe_col)
    return fn_ids, arrivals, execs, cold, evict, base_exec, duration


_AZURE_DEFAULTS = dict(
    utilization=0.8, capacity_ref=16, zipf_a=1.3, exec_median=0.15,
    exec_sigma=1.4, jitter_sigma=0.25, cold_range=(0.5, 1.5),
    burst_frac=0.3, diurnal_amp=0.6, seed=0,
)


def synth_azure_trace(n_functions: int = 200, n_requests: int = 60_000,
                      **kw) -> Trace:
    """Generate an Azure-2021-like synthetic request trace.

    ``utilization`` sets mean offered load relative to a
    ``capacity_ref``-slot server: total execution time /
    (duration * capacity_ref).
    """
    params = dict(_AZURE_DEFAULTS)
    params.update(kw)
    seed = params["seed"]
    utilization = params["utilization"]
    fn_ids, arrivals, execs, cold, evict, base_exec, duration = \
        _sample_azure(n_functions, n_requests, **params)

    functions = [FunctionProfile(j, float(cold[j]), float(evict[j]),
                                 true_mean_exec=float(base_exec[j]))
                 for j in range(n_functions)]
    reqs = [Request(i, int(f), float(a), float(e))
            for i, (f, a, e) in enumerate(zip(fn_ids, arrivals, execs))]
    meta = dict(kind="synth_azure", n_functions=n_functions,
                n_requests=len(reqs), utilization=utilization,
                duration=duration, seed=seed)
    return Trace(functions, reqs, meta)


def synth_azure_arrays(n_functions: int = 200,
                       n_requests: int = 60_000, **kw) -> dict:
    """Columnar ``synth_azure_trace``: the ``Trace.to_arrays()`` layout
    (arrival-sorted, ids by position) without materialising Request
    objects — identical arrays to
    ``synth_azure_trace(...).to_arrays()`` for the same parameters."""
    params = dict(_AZURE_DEFAULTS)
    params.update(kw)
    fn_ids, arrivals, execs, cold, evict, _, _ = \
        _sample_azure(n_functions, n_requests, **params)
    # Trace sorts by (arrival, req_id) with req_id assigned in
    # generation order — a stable arrival sort is the same permutation
    order = np.argsort(arrivals, kind="stable")
    return dict(fn_id=fn_ids[order].astype(np.int32),
                arrival=arrivals[order].astype(np.float64),
                exec_time=execs[order].astype(np.float64),
                cold_start=np.asarray(cold, np.float64),
                evict=np.asarray(evict, np.float64))


def synth_azure_windows(n_functions: int = 200,
                        n_requests: int = 60_000, *,
                        window: int = 65_536, **kw):
    """Windowed columnar emission: yield ``synth_azure_arrays`` output
    in time-ordered slabs of ``window`` requests.

    Each yielded dict carries the window's request columns (views into
    the sorted arrays: ``fn_id`` / ``arrival`` / ``exec_time``), the
    shared function catalogue (``cold_start`` / ``evict``) and the
    window's first request id ``base``; concatenating the windows
    reproduces ``synth_azure_arrays`` exactly. Consumers that stream a
    trace window by window (npz shard writers, out-of-core pipelines)
    get the same time-ordered id-range partitioning."""
    a = synth_azure_arrays(n_functions, n_requests, **kw)
    n = len(a["fn_id"])
    for base in range(0, n, int(window)):
        end = min(base + int(window), n)
        yield dict(base=base,
                   fn_id=a["fn_id"][base:end],
                   arrival=a["arrival"][base:end],
                   exec_time=a["exec_time"][base:end],
                   cold_start=a["cold_start"],
                   evict=a["evict"])

"""ESFF simulator facade (counterpart of `repro.core.jax_sim`).

``simulate_esff`` keeps the JAX facade's signature as a thin wrapper
over the engine's ESFF kernel (`repro_torch.core.engine`): ``beta`` is
the ESFF-H hysteresis (1.0 = the paper's ESFF) and ``cap_mask`` masks
slots. ``simulate_esff_jax`` / ``simulate_jax_from_trace`` are aliases
under the JAX package's names. Use `engine.simulate_policy` or
`repro_torch.api` for the other policies and for grids. Like every entry
point of the port, these run on CUDA unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.engine import (simulate_policy,
                                     simulate_policy_from_trace)
from repro_torch.core.request import Trace


def simulate_esff(fn_id, arrival, exec_time, t_cold, t_evict, *,
                  n_fns: int, capacity: int, queue_cap: int = 512,
                  beta: float = 1.0, prior: float = 0.1, cap_mask=None,
                  device=None):
    """Run ESFF over a (sorted-by-arrival) request stream. Returns the
    engine's dict: start/completion (N,), cold_starts, overflow (requests
    that found a full backlog: 0 for a valid run), ..."""
    return simulate_policy(
        fn_id, arrival, exec_time, t_cold, t_evict, policy="esff",
        n_fns=n_fns, capacity=capacity, queue_cap=queue_cap, beta=beta,
        prior=prior, cap_mask=cap_mask, device=device)


def simulate_from_trace(trace: Trace, capacity: int, *, beta: float = 1.0,
                        queue_cap: int = 1024, prior: float = 0.1,
                        device=None) -> Dict[str, np.ndarray]:
    """ESFF over a `Trace` (exact per-request mode); numpy outputs plus
    ``response`` and ``mean_response``."""
    return simulate_policy_from_trace(
        trace, "esff", capacity, beta=beta, queue_cap=queue_cap,
        prior=prior, device=device)


# the JAX package's names
simulate_esff_jax = simulate_esff
simulate_jax_from_trace = simulate_from_trace

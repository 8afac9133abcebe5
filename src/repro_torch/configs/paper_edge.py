"""The paper's own scenario config: the edge serverless platform.

Not an LM architecture: it configures the ESFF scheduling stack
(capacity, trace parameters, scheduler) that the paper's figures use.
A copy of `repro.configs.paper_edge`, field for field.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.registry import ARCHS


@dataclass(frozen=True)
class EdgeServingConfig:
    name: str = "paper-edge"
    capacity: int = 16                  # paper default C
    policy: str = "esff"
    cold_range: tuple = (0.5, 1.5)      # seconds (paper §VI-A)
    n_functions: int = 200
    n_requests: int = 60_000
    utilization: float = 0.2
    exec_median: float = 0.1
    exec_sigma: float = 1.4
    burst_frac: float = 0.3
    seed: int = 0
    intensity_ratios: tuple = (0.6, 0.8, 1.0, 1.2, 1.4)   # Fig. 6
    capacities: tuple = (8, 12, 16, 20, 24, 28, 32)        # Fig. 5


@ARCHS.register("paper_edge")
def paper_edge() -> EdgeServingConfig:
    return EdgeServingConfig()

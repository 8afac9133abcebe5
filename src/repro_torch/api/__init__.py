"""Declarative experiment API of the port (counterpart of `repro.api`)::

    from repro_torch.api import ExperimentSpec, SyntheticTrace, run

    spec = ExperimentSpec(
        traces=[SyntheticTrace.make(n_functions=200, n_requests=60_000,
                                    seed=0, utilization=0.2)],
        policies=("esff", "openwhisk_v2"), capacities=(8, 16, 32),
        queue_cap=8192)
    rs = run(spec).check()            # on CUDA; device="cpu" for the CPU
    print(rs.value("mean_response", capacity=16))
"""
from repro_torch.api.registry import (available_policies, get_kernel,
                                      register_policy, unregister_policy)
from repro_torch.api.results import ResultSet
from repro_torch.api.runner import run, run_experiment
from repro_torch.api.spec import (ArrayTrace, ExperimentSpec, HeadTrace,
                                  NpzTrace, ScaledTrace, SyntheticTrace,
                                  TraceSource, as_trace_source)
from repro_torch.cluster import (ClusterSpec, DelaySchedule,
                                 PeriodicChurn, register_router,
                                 unregister_router)
from repro_torch.core.resilience import RetryPolicy

__all__ = [
    "ExperimentSpec", "TraceSource", "SyntheticTrace", "ArrayTrace",
    "NpzTrace", "HeadTrace", "ScaledTrace",
    "as_trace_source", "ResultSet", "run", "run_experiment",
    "register_policy", "unregister_policy", "get_kernel",
    "available_policies", "ClusterSpec", "PeriodicChurn",
    "DelaySchedule", "RetryPolicy", "register_router",
    "unregister_router",
]

"""Dtype policy: the engines are float64 end to end.

Counterpart of `repro.analysis.dtypes`. Every simulated time is an
absolute f64 second; one f32 intermediate would halve the mantissa and
break the bitwise parity with the JAX package. Two checks here:

* state scan -- every floating tensor of every audited form (the eager
  loops' state, K0's launch buffers; `repro_torch.analysis.buffers`) is
  float64;
* boundary scan -- what the spec and the runners lower for the engines
  has the port's boundary dtypes: the trace operands of
  `repro_torch.api.runner.trace_operands` (int64 function ids, float64
  times: the port's, where the JAX package lowers int32 ids), the
  cluster lowerings (`ClusterSpec.delay_ops`, `churn_operand`, the
  dynamic tier's lane columns), `ExperimentSpec.resilience_ops`
  (float64, int32, bool, int32), and the ``resil`` tuple's backoff slots
  as Python floats.

The compiled side (no f32 instruction in K0's machine code) is the
``f32_sass`` gate, `repro_torch.analysis.sass`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.analysis.buffers import AuditEntry

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def audit_entry_dtypes(entry: AuditEntry, tensors=None) -> Dict:
    """Every floating tensor of the form is float64."""
    tensors = entry.build() if tensors is None else tensors
    narrow = [f"{k}: {str(t.dtype).replace('torch.', '')}"
              f"{tuple(t.shape)}" for k, t in tensors.items()
              if t.dtype in _FLOATS and t.dtype != torch.float64]
    problems = [f"{entry.name}: narrow float state {h} -- the engines are "
                "float64 only; allocate it as torch.float64."
                for h in narrow[:8]]
    return dict(entry=entry.name, passed=not narrow,
                narrow_tensors=len(narrow), problems=problems)


def audit_boundary_dtypes() -> Dict:
    """The lowered operands at a configuration of every schedule and
    fault knob."""
    import numpy as np

    from repro_torch.api.runner import trace_operands
    from repro_torch.api.spec import ExperimentSpec, SyntheticTrace
    from repro_torch.cluster.runner import pack_dynamic_lanes
    from repro_torch.cluster.spec import (ClusterSpec, DelaySchedule,
                                          PeriodicChurn)

    problems = []
    checked = {}

    def expect(name, arr, want):
        got = str(arr.dtype).replace("torch.", "")
        checked[name] = got
        if got != want:
            problems.append(f"lowering '{name}' produced {got}, the engines "
                            f"take {want} -- pin the dtype where it is "
                            "lowered.")

    cs = ClusterSpec(
        n_nodes=3, router="jsq2", net_delay=(0.0, 0.01, 0.02),
        delay_schedule=(None,
                        DelaySchedule(times=(0.0, 5.0), values=(0.01, 0.05)),
                        DelaySchedule(times=(0.0, 2.0, 4.0),
                                      values=(0.0, 0.1, 0.02), period=8.0)),
        churn=PeriodicChurn(period=10.0, duty=0.8))
    for name, arr in zip(("dtimes", "dvals", "dper"), cs.delay_ops()):
        expect(f"delay_ops.{name}", np.asarray(arr), "float64")
    expect("churn_operand", np.asarray(cs.churn_operand(horizon=30.0)),
           "float64")

    spec = ExperimentSpec(
        traces=[SyntheticTrace.make(n_functions=4, n_requests=64, seed=1)],
        policies=("esff",), capacities=(4,), fail_prob=0.1, timeouts=5.0,
        cluster=[cs], device="cpu")
    arrays = spec.expanded_traces()[0].arrays()
    stacked = {k: np.array(v)[None] for k, v in arrays.items()}
    for k, t in trace_operands(stacked, torch.device("cpu")).items():
        expect(f"trace_operands.{k}", t,
               "int64" if k == "fn_id" else "float64")
    _, lanes = pack_dynamic_lanes(spec, [cs], 1, 30.0)
    want = dict(trace_ix="int64", cap_mask="bool", n_nodes="int64",
                seeds="int64", delays="float64", router_ix="int64",
                beta_ix="int64", churn_t="float64", dtimes="float64",
                dvals="float64", dper="float64")
    for k, dt in want.items():
        expect(f"dynamic_lanes.{k}", lanes[k], dt)
    eff, nfail, tmo, key, resil = spec.resilience_ops(stacked, 4)
    expect("resilience_ops.eff_exec", eff, "float64")
    expect("resilience_ops.n_fail", nfail, "int32")
    expect("resilience_ops.is_tmo", tmo, "bool")
    expect("resilience_ops.rid_key", key, "int32")
    for i, v in enumerate(resil[2:5]):
        if type(v) is not float:
            problems.append(
                f"resil tuple slot {i + 2} is {type(v).__name__}, expected "
                "a Python float (the backoff's base, cap and jitter reach "
                "the engines as float64 scalars).")
    return dict(entry="spec_boundaries", passed=not problems,
                checked=checked, problems=problems)

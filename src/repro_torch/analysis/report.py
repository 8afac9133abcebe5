"""Gate orchestration and the JSON report of ``python -m
repro_torch.analysis`` (counterpart of `repro.analysis.report`).

One pass builds every audited form's tensors at the marker shapes on the
``meta`` device (`buffers`; no memory, no event) and runs the carry and
dtype gates on them, then the boundary dtypes, the telemetry gate (build
units; the eager loops at a tiny N on CPU tensors), the lint, and -- on
a device -- the launch audit (a tiny grid run: the only gate that runs
the engines) and the SASS scan (a card only). The report has the JAX
package's shape: ``schema``, ``markers``, ``gates`` (each ``passed``,
``entries``, ``problems``), ``wall_s``, ``passed``; plus
``not_applicable`` (the JAX gates with no counterpart, each with its
reason) and ``jax_gates`` (which port gate answers each JAX gate).
"""
from __future__ import annotations

import time
from dataclasses import asdict
from typing import Dict, List, Optional

from repro_torch.analysis.markers import MARKERS

GATES = ("carry_budget", "dtype_policy", "f32_sass", "recompilation",
         "telemetry_off", "deprecation_lint")
# the gates that need a device (the grid run, the card's machine code);
# ``--quick`` leaves them out
DEVICE_GATES = ("f32_sass", "recompilation")
# the JAX package's gates (repro.analysis.report.GATES) and the port's
# answer to each
JAX_GATES = {
    "carry_budget": "carry_budget",
    "dtype_policy": "dtype_policy + f32_sass (the compiled side)",
    "recompilation": "recompilation (launches and forms, K4a/K4b plans)",
    "deprecation_lint": "deprecation_lint",
    "telemetry_lowering": "telemetry_off",
    "copy_insertion": "not_applicable",
    "gather_cliff": "not_applicable",
}
NOT_APPLICABLE = {
    "copy_insertion": "XLA's copy-insertion pass (read-then-write liveness "
                      "copies of loop-carried tables in the HLO) has no "
                      "counterpart: K0 updates its state in place in "
                      "shared or global memory, and the eager loop's "
                      "tensors are plain PyTorch tensors.",
    "gather_cliff": "the ~25x XLA:CPU generic-gather path for multi-row "
                    "loop operands is an XLA:CPU behaviour; K0 reads the "
                    "trace through per-lane row offsets and the eager "
                    "loop through flat indices, on any device.",
}


def _merge(entries: List[Dict]) -> Dict:
    return dict(passed=all(e["passed"] for e in entries), entries=entries,
                problems=[p for e in entries for p in e.get("problems", ())])


def run_gates(gates: Optional[List[str]] = None, device=None,
              log=None) -> Dict:
    """Run ``gates`` (all by default); ``device`` (a torch.device, or
    None) is where the device gates run: without one they report that
    they did not run."""
    import torch

    gates = list(gates) if gates is not None else list(GATES)
    unknown = set(gates) - set(GATES)
    if unknown:
        raise SystemExit(f"unknown gate(s) {sorted(unknown)}; "
                         f"available: {list(GATES)}")
    say = log or (lambda *_: None)
    t0 = time.perf_counter()
    clock = [t0]

    def lap():
        """Seconds since the last lap (a gate's wall, its forms' build
        included)."""
        now = time.perf_counter()
        out, clock[0] = round(now - clock[0], 3), now
        return out
    report: Dict = dict(schema=1, markers=asdict(MARKERS), gates={},
                        torch_version=torch.__version__,
                        device=None if device is None else str(device),
                        device_name=(torch.cuda.get_device_name(device)
                                     if device is not None
                                     and device.type == "cuda" else None),
                        not_applicable=NOT_APPLICABLE, jax_gates=JAX_GATES)

    built = {}
    lap()
    if {"carry_budget", "dtype_policy"} & set(gates):
        from repro_torch.analysis.buffers import build_entries
        for e in build_entries():
            say(f"building {e.name}")
            built[e.name] = (e, e.build())

    if "carry_budget" in gates:
        from repro_torch.analysis.carries import audit_carries, audit_layouts
        say("carry budget")
        report["gates"]["carry_budget"] = _merge(
            [audit_carries(e, t) for e, t in built.values()]
            + [audit_layouts()])
        report["gates"]["carry_budget"]["wall_s"] = lap()

    if "dtype_policy" in gates:
        from repro_torch.analysis.dtypes import (audit_boundary_dtypes,
                                                 audit_entry_dtypes)
        say("dtype policy")
        report["gates"]["dtype_policy"] = _merge(
            [audit_entry_dtypes(e, t) for e, t in built.values()]
            + [audit_boundary_dtypes()])
        report["gates"]["dtype_policy"]["wall_s"] = lap()

    if "telemetry_off" in gates:
        from repro_torch.analysis.telemetry_gate import (audit_eager,
                                                         audit_units)
        say("telemetry off (build units, eager flushes)")
        report["gates"]["telemetry_off"] = _merge(
            [audit_units(device), audit_eager()])
        report["gates"]["telemetry_off"]["wall_s"] = lap()

    if "recompilation" in gates:
        from repro_torch.analysis.recompile import (audit_launches,
                                                    audit_norm_plans)
        entries = [audit_norm_plans()]
        if device is None:
            entries.append(dict(entry="experiment_grid", passed=True,
                                run=False, problems=[],
                                reason="no device given: the grid runs "
                                       "the engines"))
        else:
            say(f"recompilation audit (a tiny grid on {device})")
            entries.append(audit_launches(device))
        report["gates"]["recompilation"] = _merge(entries)
        report["gates"]["recompilation"]["wall_s"] = lap()

    if "f32_sass" in gates:
        from repro_torch.analysis.sass import audit_sass
        say("f32 in K0's machine code (cuobjdump -sass)")
        res = audit_sass(device if device is not None
                         else torch.device("cpu"))
        report["gates"]["f32_sass"] = dict(_merge([res]),
                                           run=res.get("run", True))
        report["gates"]["f32_sass"]["wall_s"] = lap()

    if "deprecation_lint" in gates:
        from repro_torch.analysis.lint import audit_lint
        say("deprecation lint")
        report["gates"]["deprecation_lint"] = _merge([audit_lint()])
        report["gates"]["deprecation_lint"]["wall_s"] = lap()

    report["wall_s"] = round(time.perf_counter() - t0, 2)
    report["passed"] = all(g["passed"] for g in report["gates"].values())
    return report

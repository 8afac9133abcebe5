"""Carry budget: no undocumented state that scales with the trace length.

Counterpart of `repro.analysis.carries`. Each form's tensors (the eager
loops' state, K0's launch buffers; `repro_torch.analysis.buffers`) are
classified by their shapes at the marker sizes. A tensor without an
N-scaling dimension is the O(F + C + HIST_BINS) state a lane. Every
tensor with one must match a rail of the form's ``allow`` list -- its
name, shape and dtype, a multiset in both directions -- and every rail
carries its reason in the owning engine module's ``CARRY_RAILS``. The
trace itself is an operand the loops only read, never a rail.

The same gate holds K0's shared-memory layouts (`layout_plan`,
`cluster_layout_plan`) to be free of the trace length: no parameter of
either names it, so a lane's layout is its functions', slots' and nodes'.
"""
from __future__ import annotations

import inspect
from collections import Counter
from typing import Dict

from repro_torch.analysis.buffers import AuditEntry


def _sig(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def audit_carries(entry: AuditEntry, tensors=None) -> Dict:
    """The gate's result for one form (see report.py for the shape):
    failed when the N-scaling tensors differ from the allowed rails."""
    m = entry.markers
    tensors = entry.build() if tensors is None else tensors
    scaling = Counter()
    n_bytes = 0
    for name, t in tensors.items():
        shape, dtype = _sig(t)
        n_bytes += t.numel() * t.element_size()
        if any(m.scales_with_n(d) for d in shape):
            scaling[(name, shape, dtype)] += 1
    rails = entry.rail_sigs()
    allowed = Counter((r, s, d) for r, (s, d) in rails.items())
    problems = []
    for (name, shape, dtype), n in (scaling - allowed).items():
        problems.append(
            f"{entry.name}: {n} {name} {'x'.join(m.shape_class(shape))} "
            f"{dtype} tensor(s) scale with the trace length N and match "
            "no allowed rail. A lane's state must be O(F + C + HIST_BINS); "
            "read per-request data from the trace operands or a "
            "positional cursor, or -- if a rail is really needed -- add "
            "it to the engine module's CARRY_RAILS with its reason and to "
            "this form's allow list.")
    for (name, shape, dtype), n in (allowed - scaling).items():
        problems.append(
            f"{entry.name}: expected {n} rail {name} "
            f"{'x'.join(m.shape_class(shape))} {dtype} but found none -- "
            "the documented rail layout changed; update the allow list "
            "and CARRY_RAILS together.")
    rationales = entry.rail_rationales()
    for r, why in rationales.items():
        if why == "(not documented)":
            problems.append(f"{entry.name}: rail {r!r} has no reason in "
                            "CARRY_RAILS")
    return dict(entry=entry.name, passed=not problems,
                tensors=len(tensors), state_bytes=n_bytes,
                n_scaling={f"{n}:{'x'.join(m.shape_class(s))}:{d}": c
                           for (n, s, d), c in sorted(scaling.items())},
                problems=problems, allowed_rails=rationales)


def audit_layouts(m=None) -> Dict:
    """K0's shared-memory layouts do not depend on the trace length:
    neither plan takes it. Reports each variant's shared bytes at the
    markers (single node, K-node)."""
    from repro_torch.analysis.markers import MARKERS
    from repro_torch.kernels import event_loop as K0
    m = m or MARKERS
    problems = []
    params = {}
    for fn in (K0.layout_plan, K0.cluster_layout_plan):
        names = list(inspect.signature(fn).parameters)
        params[fn.__name__] = names
        bad = [p for p in names if p.lower() in ("n", "n_requests",
                                                 "requests")]
        if bad:
            problems.append(f"{fn.__name__} takes the trace length "
                            f"({bad}): a lane's shared-memory layout must "
                            "not depend on N")
    plans = {v: (K0.layout_plan(m.F, m.C, v),
                 K0.cluster_layout_plan(m.F, m.K * m.C, m.K, v))
             for v in K0.VARIANTS}
    return dict(entry="k0_layouts", passed=not problems, params=params,
                smem_bytes={v: [p[0]["smem_bytes"], p[1]["smem_bytes"]]
                            for v, p in plans.items()},
                problems=problems)

"""The engine forms the audit reads, each with the state it allocates.

Counterpart of `repro.analysis.entrypoints`. The JAX package traces its
jitted loops at the marker shapes and reads the carried arrays off the
jaxpr; the port's loops are Python (the eager loops) or one kernel launch
(K0), so each `AuditEntry` here builds, at the marker shapes, the tensors
that the form's own allocator makes -- the eager loops' `_init_state`,
K0's `_Results` / `_ClusterResults` / `_TraceBuffers`, the very functions
a run calls -- on the ``meta`` device: shapes and dtypes, no memory and
no event run. The forms cover every flag that changes what is allocated:
streaming or exact, the timer rail, the options, each policy's own
state, delay, churn, resilience, the breaker, the traced window and
K0's global scratch.

``allow`` names the rails (keys of the owning engine module's
``CARRY_RAILS``) whose tensors may scale with N; `RAIL_SIGS` gives each
rail's shape and dtype at the markers, by tier.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from repro_torch.analysis.markers import MARKERS, Markers

META = torch.device("meta")

# (shape, dtype) of each rail at the markers, by tier: the eager loops
# keep a spare column (N + 1) for disabled writes; K0 keeps (L, N) rails,
# its K-node chains as one (L, 3, N) tensor, and a traced window of
# ``L * trace_capacity`` records
RAIL_SIGS: Dict[str, Dict[str, Callable[[Markers, int], tuple]]] = {
    "eager": {
        "start": lambda m, cap: ((m.L, m.N + 1), "float64"),
        "completion": lambda m, cap: ((m.L, m.N + 1), "float64"),
    },
    "eager_cluster": {
        **{k: (lambda m, cap: ((m.L, m.N + 1), "int64"))
           for k in ("nxt", "tnx", "dnx", "att")},
        **{k: (lambda m, cap: ((m.L, m.N + 1), "float64"))
           for k in ("land_t", "rt_t", "start", "completion")},
        "node_of": lambda m, cap: ((m.L, m.N + 1), "int32"),
    },
    "k0": {
        "start": lambda m, cap: ((m.L, m.N), "float64"),
        "completion": lambda m, cap: ((m.L, m.N), "float64"),
        "tr_i": lambda m, cap: ((m.L * cap, 9), "int32"),
        "tr_f": lambda m, cap: ((m.L * cap, 2), "float64"),
    },
    "k0_cluster": {
        "links": lambda m, cap: ((m.L, 3, m.N), "int32"),
        **{k: (lambda m, cap: ((m.L, m.N), "int32"))
           for k in ("node_of", "att")},
        **{k: (lambda m, cap: ((m.L, m.N), "float64"))
           for k in ("land_t", "rt_t", "start", "completion")},
        "tr_i": lambda m, cap: ((m.L * cap, 9), "int32"),
        "tr_f": lambda m, cap: ((m.L * cap, 2), "float64"),
    },
}

# the resilience tuple (max_attempts, shed mode, base, cap, jitter, seed):
# its values do not change what is allocated
_RESIL = (3, 0, 0.5, 8.0, 0.25, 42)


@dataclass(frozen=True)
class AuditEntry:
    """One engine form: ``build()`` returns its tensors by name."""

    name: str
    tier: str                      # a key of RAIL_SIGS
    build: Callable[[], Dict[str, torch.Tensor]]
    allow: Tuple[str, ...]         # rail names of CARRY_RAILS
    trace_cap: int = 0             # a traced form's records a lane
    markers: Markers = field(default=MARKERS)

    def rail_rationales(self) -> Dict[str, str]:
        if self.tier in ("eager", "k0"):
            from repro_torch.core.engine import CARRY_RAILS
        else:
            from repro_torch.cluster.engine import CARRY_RAILS
        return {r: CARRY_RAILS.get(r, "(not documented)")
                for r in self.allow}

    def rail_sigs(self) -> Dict[str, tuple]:
        sigs = RAIL_SIGS[self.tier]
        return {r: sigs[r](self.markers, self.trace_cap) for r in self.allow}


def _eager(kernel: str, m: Markers, stream=True, deadlines=False,
           tl_bins=0):
    def build():
        from repro_torch.core import engine as E
        from repro_torch.core.policies import KERNELS
        return E._init_state(KERNELS[kernel], m.L, m.C, m.F, m.N, stream,
                             META, deadlines=deadlines, tl_bins=tl_bins)
    return build


def _topology(m: Markers, router="jsq2", delay=False, churn=False,
              resil=None):
    """A `Topology` of L lanes of K nodes (built on the CPU: its flags
    are read on the host)."""
    from repro_torch.cluster.engine import Topology
    from repro_torch.cluster.routers import get_router
    from repro_torch.core.engine import BIG
    L, K, C = m.L, m.K, m.C
    i64, f64 = torch.int64, torch.float64
    delays = torch.full((L, K), 0.01 if delay else 0.0, dtype=f64)
    churn_t = None
    if churn:
        churn_t = torch.full((L, K, m.E), BIG, dtype=f64)
        churn_t[:, 1, :2] = torch.tensor([1.0, 2.0], dtype=f64)
    return Topology((get_router(router),), torch.zeros(L, dtype=i64),
                    torch.full((L,), K, dtype=i64),
                    torch.zeros(L, dtype=i64), delays,
                    torch.ones((L, K, C), dtype=torch.bool), churn_t,
                    resil=resil)


def _eager_cluster(kernel: str, m: Markers, stream=True, **topo):
    def build():
        from repro_torch.cluster.engine import _init_state
        from repro_torch.core.policies import KERNELS
        k = KERNELS[kernel]
        s, _ = _init_state(k, m.L, m.K, m.C, m.F, m.N, stream, META,
                           k.has_timers, _topology(m, **topo), False, 0)
        return s
    return build


def _k0(m: Markers, stream=True, deadlines=False, tl_bins=0, scratch=False,
        traced=False, variant="esff"):
    def build():
        from repro_torch.kernels import event_loop as K0
        plan = K0.layout_plan(m.F, m.C, variant)
        if scratch:
            # the plan of a lane whose functions' state does not fit in
            # shared memory (a large F): the state goes to global scratch
            fns = K0.VARIANTS[variant]["fn_bytes"] * m.F
            plan = dict(fn_in_shared=False, smem_bytes=plan["smem_bytes"],
                        scratch_bytes=-(-fns // 16) * 16)
        dl = (torch.empty((m.F,), dtype=torch.float64, device=META)
              if deadlines else None)
        res = K0._Results(m.L, m.N, m.F, stream, dl, tl_bins, META, plan)
        out = res.buffers()
        if traced:
            out.update(K0._TraceBuffers(m.L, K0.trace_capacity(m.N),
                                        META).buffers())
        return out
    return build


def _k0_cluster(m: Markers, stream=True, delay=False, resil=None,
                traced=False, variant="esff"):
    def build():
        from repro_torch.kernels import event_loop as K0
        plan = K0.cluster_layout_plan(m.F, m.K * m.C, m.K, variant)
        res = K0._ClusterResults(m.L, m.N, m.F, m.K, stream, None, 0, META,
                                 plan, delay, resil)
        out = res.buffers()
        if traced:
            out.update(K0._TraceBuffers(
                m.L, K0.trace_capacity(m.N, int(delay)), META).buffers())
        return out
    return build


def build_entries(m: Markers = MARKERS) -> Tuple[AuditEntry, ...]:
    """Every audited form, in the order of the report."""
    from repro_torch.core.policies import KERNELS
    from repro_torch.kernels.event_loop import trace_capacity
    eager = tuple(
        AuditEntry(f"eager_stream[{p}]", "eager", _eager(p, m), (),
                   markers=m) for p in sorted(KERNELS))
    return eager + (
        AuditEntry("eager_exact", "eager", _eager("esff", m, stream=False),
                   ("start", "completion"), markers=m),
        AuditEntry("eager_options", "eager",
                   _eager("esff", m, deadlines=True, tl_bins=m.TL), (),
                   markers=m),
        AuditEntry("eager_cluster_stream", "eager_cluster",
                   _eager_cluster("esff", m), ("nxt",), markers=m),
        AuditEntry("eager_cluster_timers", "eager_cluster",
                   _eager_cluster("openwhisk_v2", m), ("nxt", "tnx"),
                   markers=m),
        AuditEntry("eager_cluster_faascache", "eager_cluster",
                   _eager_cluster("faascache", m), ("nxt",), markers=m),
        AuditEntry("eager_cluster_delay", "eager_cluster",
                   _eager_cluster("esff", m, delay=True),
                   ("nxt", "dnx", "land_t"), markers=m),
        AuditEntry("eager_cluster_churn", "eager_cluster",
                   _eager_cluster("esff", m, delay=True, churn=True),
                   ("nxt", "dnx", "land_t"), markers=m),
        AuditEntry("eager_cluster_resil", "eager_cluster",
                   _eager_cluster("esff", m, resil=_RESIL),
                   ("nxt", "att", "rt_t"), markers=m),
        AuditEntry("eager_cluster_breaker", "eager_cluster",
                   _eager_cluster("esff", m, router="breaker",
                                  resil=_RESIL),
                   ("nxt", "att", "rt_t"), markers=m),
        AuditEntry("eager_cluster_exact_delay", "eager_cluster",
                   _eager_cluster("esff", m, stream=False, delay=True),
                   ("nxt", "dnx", "land_t", "node_of", "start",
                    "completion"), markers=m),
        AuditEntry("k0_stream", "k0", _k0(m), (), markers=m),
        AuditEntry("k0_exact", "k0", _k0(m, stream=False),
                   ("start", "completion"), markers=m),
        AuditEntry("k0_options", "k0", _k0(m, deadlines=True,
                                           tl_bins=m.TL), (), markers=m),
        AuditEntry("k0_scratch", "k0", _k0(m, scratch=True), (),
                   markers=m),
        AuditEntry("k0_traced", "k0", _k0(m, traced=True),
                   ("tr_i", "tr_f"), trace_cap=trace_capacity(m.N),
                   markers=m),
        AuditEntry("k0_cluster_stream", "k0_cluster", _k0_cluster(m),
                   ("links",), markers=m),
        AuditEntry("k0_cluster_delay", "k0_cluster",
                   _k0_cluster(m, delay=True), ("links", "land_t"),
                   markers=m),
        AuditEntry("k0_cluster_exact_delay", "k0_cluster",
                   _k0_cluster(m, stream=False, delay=True),
                   ("links", "land_t", "node_of", "start", "completion"),
                   markers=m),
        AuditEntry("k0_cluster_resil", "k0_cluster",
                   _k0_cluster(m, resil=_RESIL), ("links", "att", "rt_t"),
                   markers=m),
        AuditEntry("k0_cluster_traced", "k0_cluster",
                   _k0_cluster(m, traced=True), ("links", "tr_i", "tr_f"),
                   trace_cap=trace_capacity(m.N), markers=m),
    )

"""Recompilation, read as launches and forms.

Counterpart of `repro.analysis.recompile`. The JAX package counts jit
specialisations: the static tier pads every node's sub-stream back to
the full (1, N) row, so a whole grid of topologies shares one
specialisation a policy. The port compiles nothing at run time -- K0's
variants are built ahead (one library a unit) -- so its counterpart is
what the design promises a run launches:

* **launches** -- one engine call a policy for each tier a grid has (the
  plain single-node rows, the static tier's padded sub-streams, the
  dynamic tier's lanes), whatever the routers, node counts and capacity
  masks. On a card they are K0's launch counters; on the CPU the eager
  entries' calls (the wrappers' ``plain_calls``).
* **forms** -- the ``(variant, cluster, traced)`` forms of K0 the grid
  reaches are exactly the policies' variants in the single-node and
  K-node forms, untraced.
* **K4a / K4b geometries** -- `repro_torch.kernels.rmsnorm._plan` picks a
  geometry a shape class (body, threads a row, rows a block, vectors a
  thread, grid). The distinct plans of the served models' prefill and
  decode rows are a pure function of their shapes, pinned in
  `NORM_PLANS`: a change to the plan's classes shows here.

The grid is the JAX gate's (static hash, round_robin, weighted_random
with node capacities; dynamic jsq2 at K = 2 and 4, cold_aware) at a small
N: the count, not the result, is the point.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

POLICIES = ("esff", "sff")
N_REQUESTS = 60
LANE_CHUNK = 64
# the served rows: prompt lengths of the serving catalogues (chip_smoke's
# serve and serve_ssm phases), and one decode step, batch 1
SERVED_ROWS = {"qwen3-4b": (512, 2048, 256), "mamba2-780m": (512, 2000),
               "zamba2-2.7b": (1024,)}
# distinct K4a / K4b geometries a served model's rows reach on an H100
# (132 SMs), bf16 activations and weights: {model: (prefill, decode)}
NORM_PLANS = {"qwen3-4b": (8, 3), "mamba2-780m": (5, 2),
              "zamba2-2.7b": (3, 2)}
H100_SMS = 132


def grid_spec(device: str, lane_chunk: int = LANE_CHUNK):
    """The audit's grid: one plain row, four static and three dynamic
    topologies, two policies."""
    from repro_torch.api import ClusterSpec, ExperimentSpec, SyntheticTrace
    static = (ClusterSpec(n_nodes=2, router="hash"),
              ClusterSpec(n_nodes=2, router="round_robin"),
              ClusterSpec(n_nodes=4, router="hash"),
              ClusterSpec(n_nodes=2, router="weighted_random",
                          node_capacity=(4, 2)))
    dynamic = (ClusterSpec(n_nodes=2, router="jsq2"),
               ClusterSpec(n_nodes=4, router="jsq2"),
               ClusterSpec(n_nodes=2, router="cold_aware"))
    spec = ExperimentSpec(
        traces=[SyntheticTrace.make(n_functions=6, n_requests=N_REQUESTS,
                                    seed=3)],
        policies=POLICIES, capacities=(4,), queue_cap=256,
        lane_chunk=lane_chunk, cluster=(None,) + static + dynamic,
        device=device)
    return spec, static, dynamic


def _design(spec) -> Tuple[dict, set]:
    """The launches and forms the design promises for the grid: one call
    a policy for each tier (the grid's lanes fit one lane chunk), the
    plain row and the static tier on K0's single-node form, the dynamic
    tier on its K-node form."""
    from repro_torch.api.registry import get_kernel
    from repro_torch.kernels.event_loop import variant_of
    P = len(spec.policies)
    calls = dict(event_loop=2 * P, cluster_loop=P)
    forms = {(variant_of(get_kernel(p)), cluster, False)
             for p in spec.policies for cluster in (False, True)}
    return calls, forms


def audit_launches(device, lane_chunk: int = LANE_CHUNK) -> Dict:
    """Run the grid on ``device`` and hold its launches (its eager calls
    on the CPU) and K0 forms to the design."""
    from repro_torch.api import run_experiment
    from repro_torch.kernels import event_loop as K0
    spec, static, dynamic = grid_spec(device.type, lane_chunk=lane_chunk)
    entries = (K0.event_loop, K0.cluster_loop)
    card = device.type == "cuda"
    for e in entries:
        e.launches = e.plain_calls = 0
        e.variant_launches, e.plain_by_variant = {}, {}
        e.traced_launches = {}
    rs = run_experiment(spec, device=device)
    rs.check()
    got = {e.__name__: (e.launches if card else e.plain_calls)
           for e in entries}
    forms = set()
    for e in entries:
        by = e.variant_launches if card else e.plain_by_variant
        traced = e.traced_launches if card else {}
        for v in by:
            forms.add((v, e is K0.cluster_loop, v in traced))
    want_calls, want_forms = _design(spec)
    problems = []
    if got != want_calls:
        problems.append(
            f"{'launches' if card else 'eager calls'} {got}, the design "
            f"says {want_calls} (one a policy for each tier: the plain "
            f"row, {len(static)} static topologies as padded sub-streams "
            f"of one call, {len(dynamic)} dynamic ones as lanes of one "
            "call). More means a shared call split -- check that the "
            "static tier still packs every sub-stream as a lane of one "
            "call (cluster/static.py) and the dynamic tier every entry "
            "(cluster/runner.py); fewer means the grid no longer "
            "exercises the design and this audit must be updated.")
    if forms != want_forms:
        problems.append(f"K0 forms {sorted(forms)}, the design's "
                        f"{sorted(want_forms)}")
    return dict(entry="experiment_grid", passed=not problems,
                device=str(device), counted=("launches" if card
                                             else "plain_calls"),
                calls=got, expected=want_calls,
                forms=sorted(map(list, forms)),
                grid=dict(policies=list(spec.policies),
                          static_cells=[c.label for c in static],
                          dynamic_cells=[c.label for c in dynamic],
                          plain_rows=1, n_requests=N_REQUESTS),
                problems=problems)


def norm_rows(cfg, seq: int, batch: int = 1) -> Tuple[List[tuple],
                                                        List[tuple]]:
    """The (R, D) rows of every K4a and K4b call of one prefill of
    ``seq`` tokens (``seq=1``: one decode step) of ``cfg``'s model
    (`repro_torch.models.model`), batch ``batch``: (K4a rows, K4b rows)."""
    rows = batch * seq
    d = cfg.d_model
    k4a, k4b = [(rows, d)], []
    for li in range(cfg.n_layers):
        if cfg.family == "dense":
            if cfg.qk_norm:
                k4a += [(rows * cfg.n_heads, cfg.head_dim_),
                        (rows * cfg.n_kv_heads, cfg.head_dim_)]
            k4b.append((rows, d))                 # norm2
        else:
            k4a.append((rows, cfg.d_inner))       # Mamba2's gate norm
            if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
                k4a.append((rows, d))             # shared block's norm1
                if cfg.qk_norm:
                    k4a += [(rows * cfg.n_heads, cfg.head_dim_),
                            (rows * cfg.n_kv_heads, cfg.head_dim_)]
                k4b.append((rows, d))             # and its norm2
        if li + 1 < cfg.n_layers:
            k4b.append((rows, d))                 # the next layer's norm1
    k4b.append((batch, d))                        # the final norm
    return k4a, k4b


def norm_plans(name: str, n_sms: int = H100_SMS) -> Dict[str, int]:
    """The distinct K4a / K4b geometries of model ``name``'s served
    prefill rows (`SERVED_ROWS`) and of one decode step, bf16."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.rmsnorm import _plan
    cfg = get_arch(name)
    bf16 = torch.bfloat16

    def plans(seqs):
        shapes = set()
        for s in seqs:
            a, b = norm_rows(cfg, s)
            shapes |= set(a) | set(b)
        return {_plan(R, D, bf16, bf16, True, n_sms) for R, D in shapes}

    return dict(prefill=len(plans(SERVED_ROWS[name])), decode=len(plans((1,))))


def audit_norm_plans(n_sms: int = H100_SMS) -> Dict:
    got = {m: norm_plans(m, n_sms) for m in SERVED_ROWS}
    problems = [
        f"{m}: {g['prefill']} prefill / {g['decode']} decode K4a/K4b "
        f"geometries, pinned {NORM_PLANS[m]} -- rmsnorm._plan's shape "
        "classes changed; re-measure them (scripts/rmsnorm_timing.py "
        "--sweep) and update NORM_PLANS"
        for m, g in got.items()
        if (g["prefill"], g["decode"]) != NORM_PLANS[m]]
    return dict(entry="rmsnorm_plans", passed=not problems, plans=got,
                pinned={m: list(v) for m, v in NORM_PLANS.items()},
                n_sms=n_sms, problems=problems)

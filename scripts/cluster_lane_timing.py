"""Time K0 and its K-node variant on the smoke's grids, on one NVIDIA
GPU, for this checkout or another one (``--src``): Fig. 5's ESFF lanes
(single-node K0), fig_cluster's dynamic half (jsq2 and cold_aware at K =
1..32 nodes of 32 / K slots and K = 64 of one), fig_churn (jsq2,
cold_aware, slo_aware x K = 2, 4, 8 under churn), ESFF and SFF, and,
where the checkout has the resilience layer, fig_resilience's heaviest
spec (fail_prob 0.3, retry3) and its breaker row at fail_prob 0.6, on the
smoke's trace (F = 200, seed 0) at N = 60,000. One launch a policy and
spec on the runner's own operands, timed by CUDA events (median of 5,
after a warm-up), with each lane's events and resp_sum (to hold two
checkouts' results equal), and ptxas's registers and spills of each
event-loop library (unit). Where the checkout has the trace rail, Fig.
5's ESFF lanes are also timed traced (the traced single-node form of K0,
its records copied back), with the records a launch and the relaunches.

    python scripts/cluster_lane_timing.py [--src DIR/src] [--n-requests N]

Hold a change against its parent in one call: parent, change, change,
parent, each its own process. Prints JSON lines, the card's name and
power limit first, and appends them to ``<out>/cluster_lanes.jsonl``
(``--out``, by default ``build/timing``). Needs a CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (its timers; it imports no JAX)


def specs(api, CE, n):
    """(name, spec) pairs: the dynamic grid's two specs, fig_churn and,
    with the resilience layer, its two heaviest dynamic specs."""
    out = [(f"dynamic AGG={s.capacities[0]}", s) for s in CE.cluster_specs(
        api, n, CE.CLUSTER["dynamic_routers"], device="cuda")]
    out.append(("fig_churn", CE.churn_specs(api, n, device="cuda")[0]))
    if hasattr(CE, "resilience_specs") and hasattr(api, "RetryPolicy"):
        rs = dict(CE.resilience_specs(api, n, device="cuda"))
        out += [(k, rs[k]) for k in ("fp0.3/retry3", "breaker/fp0.6")]
    return out


def ptxas(report):
    """Each instantiation's registers and spill stores, by its policy and
    form (``<kind,lru,cold,sff>/<cluster>``)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"PolicyILi(\d)ELb(\d)ELb(\d)ELb(\d)EEELb(\d)E", line)
        if m:
            name = "{}{}{}{}/{}".format(*m.groups())
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--n-requests", type=int, default=cs.N_REQUESTS)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "timing"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import api
    from repro_torch.core.policies import KERNELS
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_loop as K0
    if not torch.cuda.is_available():
        print("cluster_lane_timing: no CUDA device", file=sys.stderr)
        return 3
    os.makedirs(args.out, exist_ok=True)
    CE = cs.cluster_expected()
    with open(os.path.join(args.out, "cluster_lanes.jsonl"), "a") as f:
        def emit(obj):
            obj = dict(src=os.path.abspath(args.src), **obj)
            f.write(json.dumps(obj) + "\n")
            print(json.dumps(obj), flush=True)
        emit(dict(card=cs.smi_line()))
        units = [s for s in _build.SOURCES if s.startswith("event_loop")]
        _build.build(units)
        emit(dict(build_s={s: _build.BUILD_INFO[s]["seconds"]
                           for s in units},
                  ptxas={s: ptxas(_build.BUILD_INFO[s]["ptxas"])
                         for s in units}))
        fargs, kw = cs.fig5_inputs(torch, api, args.n_requests, "cuda")
        kernel = KERNELS["esff"]
        fargs = cs.with_beta(torch, fargs, kernel)
        K0.event_loop(*fargs, kernel=kernel, **kw)
        ms, out, _ = cs.k0_timed(torch, K0, kernel, fargs, kw, reps=5)
        emit(dict(spec="fig5", policy="esff", ms=ms,
                  resp_sum=out["resp_sum"].tolist()))
        if hasattr(K0, "TRACED_SOURCE"):
            from repro_torch.telemetry import rail
            tkw = dict(kw, trace=True)
            with rail.collect():
                K0.event_loop(*fargs, kernel=kernel, **tkw)
                ms, tout, _ = cs.k0_timed(torch, K0, kernel, fargs, tkw,
                                          reps=5)
            emit(dict(spec="fig5 traced", policy="esff", ms=ms,
                      records=int(tout["n_events"].sum()),
                      relaunches=K0.event_loop.last_trace["relaunches"],
                      resp_sum=tout["resp_sum"].tolist()))
        for name, spec in specs(api, CE, args.n_requests):
            calls, _, _, _ = cs.cluster_calls(torch, spec, 256)
            for p, _, _, cargs, ckw in calls:
                kw = {k: v for k, v in ckw.items() if k != "keep_responses"}
                kw["threshold"] = cargs[9]
                K0.cluster_loop(*cargs[:9], **kw)     # warm up
                ms, out, _ = cs.cluster_timed(torch, K0, cargs[:9], kw,
                                              reps=5)
                ev = out["n_events"].tolist()
                emit(dict(spec=name, policy=p, n_requests=args.n_requests,
                          lanes=[e.label for e in spec.cluster], ms=ms,
                          us_per_event=1e3 * ms / max(ev), lane_events=ev,
                          resp_sum=out["resp_sum"].tolist()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

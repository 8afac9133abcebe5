"""Time K0's K-node variant on lanes with network delay and without
churn, on one NVIDIA GPU: fig_churn's topologies (jsq2, cold_aware and
slo_aware x K = 2, 4, 8 nodes of 32 / K slots, constant delays
0.004 i / (K - 1)) with their churn taken off, and the leo-delay spec's
two entries without churn (jsq2 and slo_aware on links 1..3 that swing
5 ms <-> 80 ms), ESFF and SFF, on the smoke's trace (F = 200, seed 0)
at N = 60,000. One launch a policy and spec on the runner's own
operands (`dynamic_calls`), timed by CUDA events (median of 5, after a
warm-up), with each lane's events and resp_sum (to hold two checkouts'
results equal).

    python scripts/delay_lane_timing.py [--src DIR/src] [--n-requests N]

``--src`` times another checkout's port, so that a change can be held
against its parent in one call (parent, change, change, parent, each its
own process). Prints JSON lines, the card's name and power limit first,
and appends them to ``<out>/delay_lanes.jsonl`` (``--out``, by default
``build/timing``). Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (its timers; it imports no JAX)


def delay_specs(api, CE, n):
    """The two specs: fig_churn's topologies without churn, and
    leo-delay's entries without churn."""
    src = CE.trace(api, n)
    groups = (("fig_churn_no_churn",
               [replace(e, churn=None) for e in CE.fig_churn_entries(api)]),
              ("leo_delay_no_churn",
               [e for e in CE.leo_entries(api) if e.churn is None]))
    return [(name, api.ExperimentSpec(
        traces=[src], policies=CE.CHURN["policies"],
        capacities=(CE.CHURN["agg"],), queue_cap=CE.CHURN["queue_cap"],
        cluster=entries, device="cuda")) for name, entries in groups]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--n-requests", type=int, default=cs.N_REQUESTS)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "timing"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import api
    from repro_torch.kernels import event_loop as K0
    if not torch.cuda.is_available():
        print("delay_lane_timing: no CUDA device", file=sys.stderr)
        return 3
    os.makedirs(args.out, exist_ok=True)
    CE = cs.cluster_expected()
    with open(os.path.join(args.out, "delay_lanes.jsonl"), "a") as f:
        def emit(obj):
            obj = dict(src=os.path.abspath(args.src), **obj)
            f.write(json.dumps(obj) + "\n")
            print(json.dumps(obj), flush=True)
        emit(dict(card=cs.smi_line()))
        for name, spec in delay_specs(api, CE, args.n_requests):
            calls, _, _, _ = cs.cluster_calls(torch, spec, 256)
            for p, _, _, cargs, ckw in calls:
                kw = {k: v for k, v in ckw.items() if k != "keep_responses"}
                kw["threshold"] = cargs[9]
                K0.cluster_loop(*cargs[:9], **kw)     # build and warm up
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

"""Time the traced eager loops on one NVIDIA GPU against K0's traced
forms, on the cases of ``scripts/telemetry_expected.py`` cut to each
``--n-requests`` (N = 400 is the cases' whole trace): each (case,
policy) runs traced through the kernel and through the eager loop (K0's
plain version) on the card, one run each, timed on the host clock
ending in a synchronize, and the two are held bitwise (every cell's
stream and every metric) with their largest absolute difference. This
is what ``chip_smoke.py``'s ``telemetry`` phase does at N = 40 only:
the costs printed here are why.

    python scripts/telemetry_eager_timing.py [--n-requests 40,400]

Prints JSON lines, the card's name and power limit first, and appends
them to ``<out>/telemetry_eager.jsonl`` (``--out``, by default
``build/timing``). Exits 1 when a case differs. Needs a CUDA device;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))
import chip_smoke as cs  # noqa: E402  (its comparisons; it imports no JAX)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-requests", default="40,400")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "timing"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import event_loop as K0
    if not torch.cuda.is_available():
        print("telemetry_eager_timing: no CUDA device", file=sys.stderr)
        return 3
    os.makedirs(args.out, exist_ok=True)
    tm = cs.telemetry_module()
    ok = True

    def timed(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = api.run_experiment(spec, device="cuda")
        torch.cuda.synchronize()
        return rs, (time.perf_counter() - t0) * 1e3

    with open(os.path.join(args.out, "telemetry_eager.jsonl"), "a") as f:
        def emit(obj):
            f.write(json.dumps(obj) + "\n")
            print(json.dumps(obj), flush=True)
        emit(dict(card=cs.smi_line()))
        for n in (int(x) for x in args.n_requests.split(",")):
            total = dict(kernel_ms=0.0, eager_ms=0.0)
            for c in tm.CASES:
                for p in tm.build_spec(api, c).policies:
                    spec = replace(tm.build_spec(api, c, n), policies=(p,))
                    for src in spec.expanded_traces():
                        src.arrays()
                    timed(spec)                    # build and warm up
                    card, k_ms = timed(spec)
                    orig = K0.has_device_loop
                    K0.has_device_loop = lambda kernel: False
                    try:
                        ref, e_ms = timed(spec)
                    finally:
                        K0.has_device_loop = orig
                    bad = cs.same_streams(np, card.trace, ref.trace)
                    differs = cs.same_data(np, card, ref)
                    ok = ok and not bad and not differs
                    total["kernel_ms"] += k_ms
                    total["eager_ms"] += e_ms
                    emit(dict(case=c, policy=p, n_requests=n,
                              kernel_ms=k_ms, eager_ms=e_ms,
                              records=card.trace.n_events,
                              bitwise=not bad and not differs,
                              max_abs_err=cs.max_abs_err(np, card, ref)))
            emit(dict(n_requests=n, **total))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

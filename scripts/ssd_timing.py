"""Check and time the port's SSD intra-chunk kernel (K5) on one NVIDIA GPU.

    python scripts/ssd_timing.py                 # this checkout
    python scripts/ssd_timing.py --src DIR/src   # another copy (a parent)
    python scripts/ssd_timing.py --quick         # checks, one timing
    python scripts/ssd_timing.py --bwd [--src DIR/src]   # K5's backward

Builds ``csrc/ssd_chunk.cu`` of the copy under test and prints its ptxas
report. Then, for each case of `chip_smoke.SSD_CASES` (Mamba2-780M's and
Zamba2-2.7B's full-width shapes, ragged S = 2000, g = 8, and two
narrower widths that the CUDA-core body runs in bf16), holds the
kernel against its plain version within `chip_smoke.KERNEL_TOL` and
times it: ``events_ms`` (CUDA events around 20 back-to-back calls,
median of 7 trials) and ``device_ms`` (torch.profiler's device time a
call). A copy whose wrapper takes B and C only in f32 (before the
tensor-core body) gets f32 copies of them, as its served path made.
Prints one JSON line a case and one with the card's name and power
limit. Needs a CUDA device; imports nothing of JAX.

``--bwd`` does the same for K5's backward (``csrc/ssd_chunk_bwd.cu``)
at the cases of `chip_smoke.SSD_BWD_CASES` (Mamba2-780M's and
Zamba2-2.7B's training shapes, ragged S = 1000, g = 8 in bf16, and f32):
each output within `chip_smoke.KERNEL_TOL["ssd_chunk_backward"]` of the
plain backward, two calls bitwise equal, then ``events_ms``,
``device_ms_by_kernel`` (the profiler's device ms of each kernel a
call), the bound (`chip_smoke.ssd_bwd_work`) and the body's design
floor (`chip_smoke.ssd_bwd_floor`). A copy whose backward has no
``body_launches`` (before its wgmma body) runs every case on its
CUDA-core body.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--quick", action="store_true",
                    help="the checks and one timing trial a case")
    ap.add_argument("--bwd", action="store_true",
                    help="K5's backward instead of K5")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.abspath(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_chunk as K5
    if not torch.cuda.is_available():
        print("ssd_timing: no CUDA device", file=sys.stderr)
        return 3
    src = os.path.abspath(args.src)
    if args.bwd:
        return backward(args, src, np, torch, cs, _build, K5)
    t0 = time.perf_counter()
    _build.build(("ssd_chunk",))
    info = _build.BUILD_INFO["ssd_chunk"]
    report = info["ptxas"]
    print(json.dumps(dict(src=src, build_s=time.perf_counter() - t0,
                          ptxas=dict(
                              wgmma=cs.ptxas_lines(
                                  report, "ssd_chunk_wgmma_kernel"),
                              cuda_core=cs.ptxas_lines(
                                  report, "16ssd_chunk_kernel")))),
          flush=True)
    bf16_bc = hasattr(K5, "body_for")   # this wrapper takes bf16 B and C
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    timing = dict(reps=20, trials=1 if args.quick else 7)
    failed = []
    for i, (case, shape, xd, bcd, valid, _) in enumerate(cs.SSD_CASES):
        bc = bcd if bf16_bc else "f32"
        a = cs.ssd_inputs(torch, np, *shape, dtypes[xd], dtypes[bc],
                          seed=i, valid=valid)
        call = partial(K5.ssd_chunk, *a)
        body = K5.body_for(a[0], a[3], a[4]) if bf16_bc else "cuda_core"
        (ky, ks), (py, ps) = call(), K5.ssd_chunk_plain(*a)
        torch.cuda.synchronize()
        tol = cs.KERNEL_TOL["ssd_chunk"]
        use = max(cs._tol_use(ky, py, tol), cs._tol_use(ks, ps, tol))
        finite = bool(torch.isfinite(ky).all() and torch.isfinite(ks).all())
        if use > 1.0 or not finite:
            failed.append(case)
        n_bytes, f32_ops, tc_ops = cs.ssd_work(a[0], a[3])
        print(json.dumps(dict(
            case=case, body=body, bc_dtype=bc, finite=finite, tol_use=use,
            tol_use_y=cs._tol_use(ky, py, tol),
            tol_use_states=cs._tol_use(ks, ps, tol),
            max_abs_err=max((ky - py).abs().max().item(),
                            (ks - ps).abs().max().item()),
            events_ms=cs.time_ms(torch, call, **timing),
            device_ms=cs.device_ms(torch, call),
            bound_tc_ms=cs.bound_ms(n_bytes, tc_ops, "bf16")[0],
            bound_f32_ms=cs.bound_ms(n_bytes, f32_ops, "f32")[0])),
            flush=True)
    print(json.dumps(dict(card=cs.smi_line(), failed=failed)), flush=True)
    return 1 if failed else 0


def backward(args, src, np, torch, cs, _build, K5) -> int:
    """``--bwd``: check and time K5-bwd's cases; 1 if one fails."""
    t0 = time.perf_counter()
    _build.build(("ssd_chunk_bwd",))
    report = _build.BUILD_INFO["ssd_chunk_bwd"]["ptxas"]
    print(json.dumps(dict(src=src, build_s=time.perf_counter() - t0,
                          ptxas=dict(
                              wgmma=cs.ptxas_lines(
                                  report, "ssd_bwd_main_kernel",
                                  "ssd_bwd_group_kernel",
                                  "ssd_bwd_split_kernel"),
                              cuda_core=cs.ptxas_lines(
                                  report, "ssd_chunk_bwd_kernel",
                                  "group_sum_kernel", "last_dcum_kernel")))),
          flush=True)
    has_body = hasattr(K5.ssd_chunk_backward, "body_launches")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    tol = cs.KERNEL_TOL["ssd_chunk_backward"]
    timing = dict(reps=10, trials=1 if args.quick else 5)
    failed = []
    for i, (case, shape, xd, bcd, valid) in enumerate(cs.SSD_BWD_CASES):
        b, nc, c, h, p, n, g = shape
        a = cs.ssd_inputs(torch, np, *shape, dtypes[xd], dtypes[bcd],
                          seed=i, valid=valid)
        r = np.random.default_rng(i + 100)
        dy, dS = (torch.tensor(r.normal(size=sz), dtype=torch.float32,
                               device="cuda")
                  for sz in ((b, nc, c, h, p), (b, nc, h, p, n)))
        call = partial(K5.ssd_chunk_backward, *a, dy, dS)
        body = K5.body_for(a[0], a[3], a[4]) if has_body else \
            "cuda_core"
        got, again = call(), call()
        want = K5.ssd_chunk_backward_plain(*a, dy, dS)
        torch.cuda.synchronize()
        uses = []
        for k, w in zip(got, want):
            lim = tol["atol"] + tol["rtol"] * w.float().abs()
            if w.dtype == torch.bfloat16:
                lim = lim + tol["out_round"] * w.float().abs()
            uses.append(((k.float() - w.float()).abs() / lim).max().item())
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        if max(uses) > 1.0 or not bitwise:
            failed.append(case)
        del got, again, want
        n_bytes, f32_ops, tc_ops = cs.ssd_bwd_work(a[0], a[3])
        tc = body == "wgmma"
        bound, bound_by = cs.bound_ms(n_bytes, tc_ops if tc else f32_ops,
                                      "bf16" if tc else "f32")
        print(json.dumps(dict(
            case=case, body=body, bitwise=bitwise, tol_use=max(uses),
            tol_use_by_output=dict(zip(("dx", "ddt", "dcum", "dB", "dC"),
                                       uses)),
            events_ms=cs.time_ms(torch, call, **timing),
            device_ms_by_kernel=cs.device_split(torch, call, reps=5),
            bound_ms=bound, bound_by=bound_by,
            **cs.ssd_bwd_floor(a[0], a[3], body))), flush=True)
    print(json.dumps(dict(card=cs.smi_line(), failed=failed)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Check and time the port's SSD intra-chunk kernel (K5) on one NVIDIA GPU.

    python scripts/ssd_timing.py                 # this checkout
    python scripts/ssd_timing.py --src DIR/src   # another copy (a parent)
    python scripts/ssd_timing.py --quick         # checks, one timing

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


if __name__ == "__main__":
    sys.exit(main())

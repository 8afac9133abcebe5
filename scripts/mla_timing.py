"""Check and time the port's MLA decode kernel (K3-mla) on one NVIDIA GPU.

    python scripts/mla_timing.py                 # this checkout
    python scripts/mla_timing.py --src DIR/src   # another copy (a parent)
    python scripts/mla_timing.py --quick         # checks, one timing

Builds ``csrc/mla_decode.cu`` of the copy under test and prints its
ptxas report (registers, spills of each body's kernel). Then, at each
row of `chip_smoke.MLA_DECODE_CASES` (DeepSeek-V3's H 128, (R, DR) =
(512, 64), T 2560: B 1 at length 0, 511 and 2559, B 2 at 2559), in bf16
and f32, for each body the copy has (its wrapper's ``MLA_BODIES``, a
body named through ``body=``; a copy without them runs its one body),
holds the kernel against its plain version within
`chip_smoke.KERNEL_TOL["mla_decode_attention"]`, checks that a repeated
call is bitwise equal, and times it: ``ms`` (CUDA events around 10
back-to-back calls, the bodies and the plain version in turns, median
of 5 trials) and ``device_ms`` (torch.profiler's device time a call),
beside the bound (`chip_smoke.bound_ms` of the bytes each input read
once and the output written once, and the products' operations). With
a copy that has `mla_kernel_info`, also each body's shared memory a
block and its blocks an SM. Prints one JSON line a row and one with the
card's name and power limit. ``--sweep`` prints instead each body's
device time at the plans of SWEEP (`sweep`). Needs a CUDA device; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from functools import partial

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--quick", action="store_true",
                    help="the checks and one timing trial a row")
    ap.add_argument("--sweep", action="store_true",
                    help="only the plan sweep (`sweep`): each body's "
                    "device time at chosen (per, n_splits)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.abspath(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    if not torch.cuda.is_available():
        print("mla_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    _build.build(["mla_decode"])
    report = _build.BUILD_INFO["mla_decode"]["ptxas"]
    bodies = getattr(DA, "MLA_BODIES", (None,))
    names = {"cuda_core": "17mla_decode_kernel",
             "mma": "mla_decode_mma_kernel"}
    info = {}
    for body in bodies:
        k = {} if body is None else dict(
            ptxas=cs.ptxas_lines(report, names[body]))
        if hasattr(DA, "mla_kernel_info"):
            k.update(DA.mla_kernel_info(body))
        info[str(body)] = k
    if bodies == (None,):
        info["None"]["ptxas"] = cs.ptxas_lines(report, "mla_decode")
    print(json.dumps(dict(src=args.src, card=card, bodies=info)),
          flush=True)
    if args.sweep:
        return sweep(torch, cs, DA, card)
    timing = dict(reps=10, trials=1 if args.quick else 5)
    dev = torch.device("cuda")
    tol = cs.KERNEL_TOL["mla_decode_attention"]
    H, R, DR = 128, 512, 64
    scale = 1.0 / math.sqrt(128 + DR)
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for B, T, length in cs.MLA_DECODE_CASES:
            gen = torch.Generator(device=dev).manual_seed(0)

            def randn(*shape):
                return torch.randn(*shape, generator=gen,
                                   device=dev).to(dtype)
            q_abs, q_rope = randn(B, 1, H, R), randn(B, 1, H, DR)
            c_kv, k_rope = randn(B, T, R), randn(B, T, DR)
            a = (q_abs, q_rope, c_kv, k_rope, length)
            plain = partial(DA.mla_decode_attention_plain, *a, scale=scale)
            want = plain()
            seen = torch.arange(T, device=dev) <= length
            abs_v = cs.mla_f32(torch, q_abs, q_rope, c_kv, k_rope, seen,
                               scale, value=c_kv.abs()).float()
            calls, row = {}, {}
            for body in bodies:
                if body == "mma" and dtype != torch.bfloat16:
                    continue
                kw = {} if body is None else dict(body=body)
                call = partial(DA.mla_decode_attention, *a, scale=scale,
                               **kw)
                got, again = call(), call()
                torch.cuda.synchronize()
                row[str(body)] = dict(
                    tol_use=cs._tol_use(got, want, tol, abs_v),
                    max_abs_err=(got.float() - want.float()).abs()
                    .max().item(),
                    bitwise_repeat=bool(torch.equal(got, again)),
                    device_ms=cs.device_ms(torch, call))
                calls[str(body)] = call
            ms = cs.time_in_turns(torch, [*calls.values(), plain], **timing)
            for k, t in zip(calls, ms):
                row[k]["ms"] = t
            n = min(length + 1, T)
            size = 2 if dtype == torch.bfloat16 else 4
            n_bytes = size * B * (H * (R + DR) + n * (R + DR) + H * R)
            n_ops = 2 * B * H * n * (2 * R + DR)
            b, by = cs.bound_ms(n_bytes, n_ops, kind)
            print(json.dumps(dict(
                case=f"mla B={B} T={T} length={length} {kind}",
                bodies=row, plain_ms=ms[-1], bound_ms=b, bound_by=by,
                card=card)), flush=True)
            del want, abs_v, q_abs, q_rope, c_kv, k_rope
    return 0


# the sweep's plans (B, H, n_valid, per, n_splits): one block's range of
# 1 and 32 positions with no cluster to merge; one tile a block in a
# cluster of 16; 16 tiles a block with no merge; the served n_valid 2560
# cut into 16, 14, 12, 10, 8, 4 and 1 ranges; a lone block
SWEEP = ((1, 128, 1, 1, 1), (1, 128, 32, 32, 1), (1, 128, 512, 32, 16),
         (1, 128, 512, 512, 1), (1, 128, 2560, 160, 16),
         (1, 128, 2560, 192, 14), (1, 128, 2560, 224, 12),
         (1, 128, 2560, 256, 10), (1, 128, 2560, 320, 8),
         (1, 128, 2560, 640, 4), (1, 128, 2560, 2560, 1),
         (1, 16, 1, 1, 1), (1, 16, 2560, 160, 16))


def sweep(torch, cs, DA, card):
    """Each body's device time (torch.profiler) at SWEEP's plans, the C
    entry called with the plan itself, bf16, T 2560: what a call costs
    with nothing to read, what a tile adds, what the cluster's merge
    adds. Prints one JSON line a plan."""
    import ctypes
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    fn = _build.c_entry("mla_decode", "mla_decode_attention",
                        DA._MLA_ARGTYPES)
    R, DR, T = 512, 64, 2560
    for B, H, n_valid, per, n_splits in SWEEP:
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q_abs, q_rope = randn(B, 1, H, R), randn(B, 1, H, DR)
        c_kv, k_rope = randn(B, T, R), randn(B, T, DR)
        lat = torch.empty_like(q_abs)
        stream = _build.stream_of(dev)
        row = {}
        for code, body in enumerate(DA.MLA_BODIES):
            def call(code=code):
                _build.launch_check(fn(
                    code, _build.DTYPE_CODE[torch.bfloat16],
                    q_abs.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
                    k_rope.data_ptr(), lat.data_ptr(), B, T, H, R, DR,
                    n_valid - 1, per, n_splits, ctypes.c_float(0.07),
                    stream), "sweep")
            row[body] = cs.device_ms(torch, call) * 1e3
        print(json.dumps(dict(B=B, H=H, n_valid=n_valid, per=per,
                              n_splits=n_splits, device_us=row,
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

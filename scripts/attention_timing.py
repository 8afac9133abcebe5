"""Time the port's prefill and decode attention kernels (K2, K3) on one
NVIDIA GPU in several ways, to tell apart what each way measures.

    python scripts/attention_timing.py                 # this checkout
    python scripts/attention_timing.py --src DIR/src   # another copy

At Qwen3-4B's serving shapes (K2: causal S = 2048, 32 heads, 8 kv heads,
head_dim 128; K3: T = 2560, length 2559; bf16, B = 1), for the kernel
and for `F.scaled_dot_product_attention` beside it:
- ``events_ms``: CUDA events around 20 back-to-back calls (the inputs
  stay in L2), median of 7;
- ``cold_ms``: CUDA events around one call after a 256 MB write that
  evicts L2, median of 20;
- ``prof_us_per_call`` and ``prof_us_per_record``: torch.profiler's
  device time of 20 calls divided by 20, and divided by the number of
  kernel records it kept (``records``: fewer than 20 x the kernels a
  call launches means the profiler dropped some).
Prints one JSON line, with the card's name and power limit. Needs a
CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from functools import partial


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device", file=sys.stderr)
        return 3
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def events_ms(fn, reps=20, trials=7):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(trials):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / reps)
        return sorted(ts)[len(ts) // 2]

    def cold_ms(fn, trials=20):
        ts = []
        for _ in range(trials):
            flush.fill_(1.0)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        return sorted(ts)[len(ts) // 2]

    def prof(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in p.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in rows)
        n = sum(e.count for e in rows)
        return dict(prof_us_per_call=us / reps,
                    prof_us_per_record=us / n if n else None, records=n,
                    kernels=sorted({e.key[:60] for e in rows}))

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        return dict(events_ms=events_ms(fn), cold_ms=cold_ms(fn), **prof(fn))

    H, KVH, D, S = 32, 8, 128, 2048
    q, k, v = randn(1, S, H, D), randn(1, S, KVH, D), randn(1, S, KVH, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    T, length = 2560, 2559
    dq, kc, vc = randn(1, 1, H, D), randn(1, T, KVH, D), randn(1, T, KVH, D)
    res = dict(
        src=os.path.abspath(args.src),
        k2=measure(partial(FA.flash_attention, q, k, v, causal=True)),
        k2_sdpa=measure(partial(F.scaled_dot_product_attention, qt, kt, vt,
                                is_causal=True, enable_gqa=True)),
        k3=measure(partial(DA.decode_attention, dq, kc, vc, length)),
        k3_sdpa=measure(partial(
            F.scaled_dot_product_attention, dq.transpose(1, 2),
            kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res["device"] = dict(name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

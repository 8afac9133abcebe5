"""Where a full-width training step of the port goes, on one NVIDIA GPU.

    python scripts/train_profile.py [--arch qwen3-4b] [--layers N]
        [--batch 4] [--seq 1024]

``--arch`` (qwen3-4b, mamba2-780m or zamba2-2.7b) at full width (bf16,
f32 AdamW moments; ``--layers`` cuts the depth), random weights,
`repro_torch.train.data` batches: two warm-up steps, then one step timed
by CUDA events in three parts (the forward `Model.loss`, its backward,
the AdamW update) and one step under torch.profiler, whose device time
is summed by kernel group: K2 forward, K2 backward (its three kernels),
K5 forward and backward (its three kernels, on either body), the norms
forward (K4a, K4b) and backward, matrix products (cuBLAS), and the rest (elementwise,
the optimizer's passes, the SSD's plain ops, the cross-entropy, the
embedding's scatter), with the kernel launches of the step and the
device's busy share of the timed step. Prints one JSON line with the
card's name and power limit. Needs a CUDA device; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

GROUPS = (("k5_backward", ("ssd_bwd_", "ssd_chunk_bwd_kernel",
                           "group_sum_kernel", "last_dcum_kernel")),
          ("k5_forward", ("ssd_chunk_wgmma_kernel", "ssd_chunk_kernel")),
          ("k2_backward", ("dkdv_", "dq_kernel", "dq_wgmma_kernel",
                           "delta_kernel")),
          ("k2_forward", ("flash_attention_wgmma_kernel",
                          "flash_attention_kernel")),
          ("norms_backward", ("rmsnorm_bwd_", "dw_kernel")),
          ("norms_forward", ("rmsnorm",)),
          ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the arch's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.data import synthetic_lm_batch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    cfg = cfg.replace(n_layers=args.layers or cfg.n_layers)
    model = build_model(cfg, dev, trainable=True)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    ocfg = AdamWConfig()
    state = adamw_init(ocfg, params)

    def step(i, marks=None):
        batch = {k: torch.as_tensor(v).long().to(dev) for k, v in
                 synthetic_lm_batch(cfg, args.batch, args.seq, i).items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = model.loss(batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        adamw_update(ocfg, params, {k: p.grad for k, p in params.items()},
                     state)
        for p in params.values():
            p.grad = None
        ev[3].record()
        ev[3].synchronize()
        return dict(forward_ms=ev[0].elapsed_time(ev[1]),
                    backward_ms=ev[1].elapsed_time(ev[2]),
                    optimizer_ms=ev[2].elapsed_time(ev[3]),
                    step_ms=ev[0].elapsed_time(ev[3]), loss=loss.item())

    for i in range(2):
        step(i)
    timed = step(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(3)
        torch.cuda.synchronize()
    by_group, top, launches = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        launches += e.count
        g = group_of(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total / 1e3
        top.append((e.self_device_time_total / 1e3, e.count, e.key[:90]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        config=dict(arch=args.arch, layers=cfg.n_layers, batch=args.batch,
                    seq=args.seq),
        timed_step=timed, device_ms_by_group=by_group,
        device_ms_total=sum(by_group.values()),
        busy_share=sum(by_group.values()) / timed["step_ms"],
        device_ops=launches,
        top=[dict(device_ms=t, count=c, name=n)
             for t, c, n in sorted(top, reverse=True)[:15]],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

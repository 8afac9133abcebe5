"""Which kernel of the training path moves the gradients how far, on one
NVIDIA GPU: the breakdown of the kernel path's distance from the plain
path (chip_smoke.py's train gate (b)).

    python scripts/train_grad_breakdown.py [--arch qwen3-4b] [--layers N]
        [--attn-every K] [--batch 2] [--seq 1024] [--dtype DTYPE]
        [--seed 0] [--perturb-ssd]
        [--out build/timing/train_grad_breakdown.json] [--src DIR/src]
    python scripts/train_grad_breakdown.py --device cpu --smoke --seq 64

Train (b)'s setup: ``--arch`` (qwen3-4b, mamba2-780m or zamba2-2.7b) at
full width cut to ``--layers`` layers (by default chip_smoke.py's
TRAIN_ARCHS: 2, and Zamba2-2.7B 1 with ``--attn-every`` 1, one shared
block), in the config's dtype (bf16) or ``--dtype``, weights and one batch of
`repro_torch.train.data` from ``--seed`` (0). The reference is one loss and
backward with every kernel swapped for its plain version (autograd
through `flash_attention_plain`, `rmsnorm_plain`,
`rmsnorm_residual_plain`, `ssd_chunk_plain`: chip_smoke.plain_kernels).
The path's kernel groups: K2's forward and backward (dense, hybrid), the
norms' forward (K4a and K4b) and their backward, K5's forward and
backward (ssm, hybrid). Each run takes every group either as its kernel
or as its plain version (a forward's plain version is the plain
function; a backward's is the ``*_backward_plain`` function in place of
the kernel, behind the same autograd Function): all combinations of up
to four groups, and for the hybrid family's six the whole path, each
group alone and each group plain (14 runs); it prints for each the
loss's and every parameter gradient's norm-wise relative error ||g -
g_plain|| / ||g_plain|| against the reference, and the launches of each
kernel in that run. The summary line gives, for every gradient, the
error of the whole kernel path, of each group alone (the others plain)
and of the path with that group plain.

``--perturb-ssd`` asks instead how far the plain path's gradients are
determined at all: three runs, the whole kernel path, the plain path,
and the plain path with K5's output y multiplied by 1 + 1e-6 z (z ~ N(0,
1), a fixed seed); its one line gives the worst norm-wise relative
gradient error of the kernel path (gate (b)'s number) and of the
perturbed plain path (the sensitivity: how far a change far below any
kernel's error moves the plain path's own gradients), with the
parameters they fall on.

Prints the card's name and power limit; needs a CUDA device; imports
nothing of JAX. ``--device cpu --smoke`` runs the smoke config
on the CPU, where every kernel takes its plain version (a check of the
script, not of the kernels).
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys

# the kernel groups of each family's training path
GROUPS = {"dense": ("attn_fwd", "attn_bwd", "norm_fwd", "norm_bwd"),
          "ssm": ("norm_fwd", "norm_bwd", "ssd_fwd", "ssd_bwd"),
          "hybrid": ("attn_fwd", "attn_bwd", "norm_fwd", "norm_bwd",
                     "ssd_fwd", "ssd_bwd")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: chip_smoke.TRAIN_ARCHS's)")
    ap.add_argument("--attn-every", type=int, default=None,
                    help="the hybrid family's group size (default: "
                    "chip_smoke.TRAIN_ARCHS's)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dtype", default=None,
                    help="the parameters' and activations' dtype (default: "
                    "the config's, bfloat16 at full width)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' and the batch's seed")
    ap.add_argument("--perturb-ssd", action="store_true",
                    help="the plain path's sensitivity to a 1e-6 nudge of "
                    "K5's output instead of the breakdown by group")
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"),
        help="the port's sources (another checkout's, to break down its "
        "kernels)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config instead of the full width")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "build", "timing",
        "train_grad_breakdown.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), ".."))
    import torch

    from chip_smoke import TRAIN_ARCHS

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_chunk as K5
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    from repro_torch.train.data import synthetic_lm_batch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("train_grad_breakdown: no CUDA device", file=sys.stderr)
        return 3

    def plain_lse(q, k, scale):
        g = q.shape[2] // k.shape[2]
        s = torch.einsum("bshd,bthd->bhst", q.float(),
                         k.repeat_interleave(g, 2).float()) * scale
        pos = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
        return torch.logsumexp(s, -1)

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, fk, bk):
            scale = 1.0 / math.sqrt(q.shape[-1])
            if fk:
                out, lse = FA._forward(q, k, v, True, None, bk)
            else:
                out = FA.flash_attention_plain(q, k, v,
                                               causal=True).contiguous()
                lse = plain_lse(q, k, scale) if bk else None
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.bk = bk
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            if ctx.bk:
                grads = FA.flash_attention_backward(q, k, v, out,
                                                    do.contiguous(), lse)
            else:
                grads = FA.flash_attention_backward_plain(q, k, v, do)
            return (*grads, None, None)

    class Norm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, eps, fk, bk):
            ctx.save_for_backward(x, w)
            ctx.eps, ctx.bk = eps, bk
            return RN._rmsnorm(x, w, eps) if fk else \
                RN.rmsnorm_plain(x, w, eps)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            if ctx.bk:
                dx, dw = RN.rmsnorm_backward(x, w, g.contiguous(),
                                             eps=ctx.eps)
            else:
                dx, dw = RN.rmsnorm_backward_plain(x, w, g, ctx.eps)
            return dx, dw, None, None, None

    class NormRes(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, r, w, eps, fk, bk):
            ctx.save_for_backward(x, r, w)
            ctx.eps, ctx.bk = eps, bk
            ctx.set_materialize_grads(False)
            return RN._rmsnorm_residual(x, r, w, eps) if fk else \
                RN.rmsnorm_residual_plain(x, r, w, eps)

        @staticmethod
        def backward(ctx, g, gres):
            x, r, w = ctx.saved_tensors
            g = torch.zeros_like(x) if g is None else g.contiguous()
            gres = None if gres is None else gres.contiguous()
            if ctx.bk:
                dx, dw = RN.rmsnorm_residual_backward(x, r, w, g, gres,
                                                      eps=ctx.eps)
            else:
                dx, dw = RN.rmsnorm_residual_backward_plain(x, r, w, g,
                                                            gres, ctx.eps)
            return dx, dx, dw, None, None, None

    class SSD(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, cum, B, C, fk, bk):
            ctx.save_for_backward(x, dt, cum, B, C)
            ctx.bk = bk
            return K5._forward(x, dt, cum, B, C) if fk else \
                K5.ssd_chunk_plain(x, dt, cum, B, C)

        @staticmethod
        def backward(ctx, dy, dS):
            ins = ctx.saved_tensors
            dy, dS = dy.contiguous(), dS.contiguous()
            grads = (K5.ssd_chunk_backward(*ins, dy, dS) if ctx.bk else
                     K5.ssd_chunk_backward_plain(*ins, dy, dS))
            return (*grads, None, None)

    saved = (L.flash_attention, L.rmsnorm, M.rmsnorm_residual, MB.ssd_chunk)

    def use(on):
        """Route the model's K2, K4a and K4b through the groups ``on``
        (a set of GROUPS); None: the plain path (autograd through the
        plain functions)."""
        if on is None:
            L.flash_attention = (
                lambda q, k, v, causal=True, scale=None, window=None:
                FA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
            L.rmsnorm = lambda x, w, eps=1e-6: RN.rmsnorm_plain(x, w, eps)
            M.rmsnorm_residual = (lambda x, r, w, eps=1e-6:
                                  RN.rmsnorm_residual_plain(x, r, w, eps))
            MB.ssd_chunk = K5.ssd_chunk_plain
            return
        af, ab = "attn_fwd" in on, "attn_bwd" in on
        nf, nb = "norm_fwd" in on, "norm_bwd" in on
        sf, sb = "ssd_fwd" in on, "ssd_bwd" in on
        MB.ssd_chunk = (lambda x, dt, cum, B, C:
                        SSD.apply(x, dt, cum, B, C, sf, sb))
        # training attends with no window (the hybrid's prefill past its
        # cache is serving only)
        L.flash_attention = (lambda q, k, v, causal=True, scale=None,
                             window=None: Attn.apply(q, k, v, af, ab))
        L.rmsnorm = lambda x, w, eps=1e-6: Norm.apply(x, w, eps, nf, nb)
        M.rmsnorm_residual = (lambda x, r, w, eps=1e-6:
                              NormRes.apply(x, r, w, eps, nf, nb))

    cfg = get_arch(args.arch)
    cut = dict(TRAIN_ARCHS.get(args.arch, dict(n_layers=2)))
    if args.layers:
        cut["n_layers"] = args.layers
    if args.attn_every:
        cut["attn_every"] = args.attn_every
    if args.dtype:
        cut.update(param_dtype=args.dtype, compute_dtype=args.dtype)
    cfg = (cfg.smoke() if args.smoke else cfg).replace(**cut)
    layers = cfg.n_layers
    groups = GROUPS[cfg.family]
    model = build_model(cfg, dev, trainable=True)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    batch = {k: torch.as_tensor(v).long().to(dev) for k, v in
             synthetic_lm_batch(cfg, args.batch, args.seq,
                                args.seed).items()}
    wrappers = {"flash_attention": FA.flash_attention,
                "flash_attention_backward": FA.flash_attention_backward,
                "rmsnorm": RN.rmsnorm, "rmsnorm_backward":
                RN.rmsnorm_backward, "rmsnorm_residual":
                RN.rmsnorm_residual, "rmsnorm_residual_backward":
                RN.rmsnorm_residual_backward, "ssd_chunk": K5.ssd_chunk,
                "ssd_chunk_backward": K5.ssd_chunk_backward}

    def perturbed(*a):
        y, st = K5.ssd_chunk_plain(*a)
        g = torch.Generator(device=dev).manual_seed(1)
        return y * (1 + 1e-6 * torch.randn(y.shape, generator=g,
                                           device=dev)), st

    def run(on, ssd=None):
        use(on)
        if ssd is not None:
            MB.ssd_chunk = ssd
        before = {n: w.launches for n, w in wrappers.items()}
        try:
            for p in model.parameters():
                p.grad = None
            loss, _ = model.loss(batch)
            loss.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        finally:
            (L.flash_attention, L.rmsnorm, M.rmsnorm_residual,
             MB.ssd_chunk) = saved
        launches = {n: w.launches - before[n] for n, w in wrappers.items()}
        return loss.item(), {n: p.grad.float() for n, p in
                             model.named_parameters()}, launches

    def smi():
        if dev.type != "cuda":
            return {}
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        return dict(device=torch.cuda.get_device_name(0), nvidia_smi=line)

    lp, gp, _ = run(None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.perturb_ssd:
        def worst(g):
            rel = {n: ((g[n] - gp[n]).norm() / gp[n].norm()).item()
                   for n in gp}
            n = max(rel, key=rel.get)
            return rel[n], n
        lk, gk, _ = run(set(groups))
        kv, kn = worst(gk)
        del gk
        _, gq, _ = run(None, perturbed)
        sv, sn = worst(gq)
        row = dict(arch=args.arch, layers=layers, attn_every=cfg.attn_every,
                   dtype=cfg.param_dtype, seed=args.seed, kernel_vs_plain=kv,
                   kernel_vs_plain_worst=kn, sensitivity_1e6=sv,
                   sensitivity_worst=sn, loss_rel_err=abs(lk / lp - 1),
                   **smi())
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(json.dumps(row), flush=True)
        return 0
    rows = []
    if len(groups) <= 4:
        sets = [{g for g, b in zip(groups, bits) if b} for bits in
                itertools.product((False, True), repeat=len(groups))]
    else:
        sets = ([set(), set(groups)] + [{g} for g in groups]
                + [set(groups) - {g} for g in groups])
    for on in sets:
        lk, gk, launches = run(on)
        rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item()
               for n in gk}
        del gk
        worst = max(rel, key=rel.get)
        row = dict(kernels=sorted(on, key=groups.index),
                   loss_rel_err=abs(lk / lp - 1), grad_rel_err=rel,
                   worst=[worst, rel[worst]], launches=launches)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def err(on):
        return next(r for r in rows if set(r["kernels"]) == set(on))

    names = list(gp)
    full = err(groups)["grad_rel_err"]
    summary = dict(
        config=f"{args.arch} {'smoke' if args.smoke else 'full width'}, "
        f"{layers} layers, {cfg.pdtype}, "
        f"B={args.batch}, S={args.seq}",
        all_kernels=full,
        alone={g: err({g})["grad_rel_err"] for g in groups},
        all_but={g: err(set(groups) - {g})["grad_rel_err"] for g in groups},
        worst_all_kernels=max(full.items(), key=lambda kv: kv[1]),
        plain_through_functions_max=max(err(())["grad_rel_err"].values()),
        names=names, **smi())
    with open(args.out, "w") as f:
        json.dump(dict(rows=rows, summary=summary), f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

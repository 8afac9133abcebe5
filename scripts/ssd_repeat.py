"""Repeat the f32 chunked SSD of Mamba2-780M's widths on the card, and
K5 alone, to find what moves between runs.

The card test `tests/test_torch_cuda.py::
test_ssd_chunked_ragged_on_card_matches_cpu` (S 2000, 48 heads of 64,
state 128, one group, chunk 256, f32: K5's CUDA-core body and the plain
chunk loop) holds `models.mamba.ssd_chunked` on the card to the CPU at
rtol = atol = 2e-4. This script runs that body ``--repeats`` times in
one process and ``--fresh`` times in new processes, on the same device
inputs, and for each run:

* counts the elements of y and the final state beyond that limit;
* holds K5's (y_diag, states) to the first call's bitwise, through the
  CUDA-core body on the test's f32 inputs and through the wgmma body on
  Mamba2-780M's served bf16 shape (x, B, C bf16), ``--k5-calls`` calls
  each a run;
* on the first run and on any miss, holds the card's cum, K5's outputs,
  S_prev, y_off and y to the same steps in f64 on the CPU, beside the
  CPU's f32 steps, so that the step that moved shows.

``--sanitize`` runs K5 once through each body at those shapes and
exits: the program to hand to the CUDA toolkit's ``compute-sanitizer
--tool racecheck|synccheck|initcheck|memcheck``. ``--src DIR/src`` runs
another checkout's package (an unpacked parent). Needs a card. Prints
one JSON line; with ``--out`` writes it there too.

    python scripts/ssd_repeat.py --repeats 200 --fresh 20
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_, H_, P_, N_, CHUNK = 2000, 48, 64, 128, 256
TOL = dict(rtol=2e-4, atol=2e-4)


def inputs(np):
    """The card test's inputs (default_rng(0))."""
    r = np.random.default_rng(0)
    x = r.normal(size=(1, L_, H_, P_))
    dt = r.uniform(0.01, 0.2, (1, L_, H_))
    A = -r.uniform(0.5, 2.0, (H_,))
    B, C = r.normal(size=(2, 1, L_, 1, N_))
    return x, dt, A, B, C


def parts(torch, K5, x, dt, A, B, C, chunk=CHUNK):
    """`ssd_chunked`'s steps, written out (the same ops, in its order),
    in the inputs' dtype: {cum, y_diag, states, S_prev, y_off, y, S}. On
    f64 CPU tensors K5's step is its plain version in f64."""
    F = torch.nn.functional
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc, hg, ft = (l + pad) // chunk, h // g, x.dtype
    xc = x.reshape(b, nc, chunk, h, p).contiguous()
    dtc = dt.reshape(b, nc, chunk, h).contiguous()
    Bc = B.reshape(b, nc, chunk, g, n).contiguous()
    Cc = C.reshape(b, nc, chunk, g, n).contiguous()
    cum = torch.cumsum(dtc * A, dim=2)
    if ft == torch.float64:
        y_diag, states = plain64(torch, xc, dtc, cum, Bc, Cc)
    else:
        y_diag, states = K5.ssd_chunk(xc, dtc, cum, Bc, Cc)
    S = torch.zeros(b, h, p, n, dtype=ft, device=x.device)
    decay = torch.exp(cum[:, :, -1])
    S_prev = []
    for ci in range(nc):
        S_prev.append(S)
        S = S * decay[:, ci, :, None, None] + states[:, ci]
    S_prev = torch.stack(S_prev, dim=1)
    y_off = torch.einsum("bcsgn,bcgjpn->bcsgjp", Cc,
                         S_prev.view(b, nc, g, hg, p, n))
    y_off = y_off * torch.exp(cum).view(b, nc, chunk, g, hg, 1)
    y = (y_diag + y_off.reshape(b, nc, chunk, h, p)).reshape(
        b, nc * chunk, h, p)[:, :l]
    return dict(cum=cum, y_diag=y_diag, states=states, S_prev=S_prev,
                y_off=y_off, y=y, S=S)


def plain64(torch, x, dt, cum, B, C):
    """`kernels.ssd_chunk.ssd_chunk_plain` in f64 (it widens to f32)."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    hg = h // g
    xf = x.view(b, nc, c, g, hg, p)
    dtf, cumf = dt.view(b, nc, c, g, hg), cum.view(b, nc, c, g, hg)
    diff = cumf[:, :, :, None] - cumf[:, :, None, :]
    causal = torch.ones(c, c, dtype=torch.bool).tril()
    diff = diff.masked_fill(~causal[:, :, None, None], float("-inf"))
    scores = torch.einsum("bcsgn,bctgn->bcstg", C, B)
    y = torch.einsum("bcstgj,bctgj,bctgjp->bcsgjp",
                     scores[..., None] * torch.exp(diff), dtf, xf)
    decay_in = torch.exp(cumf[:, :, -1:] - cumf) * dtf
    S = torch.einsum("bctgn,bctgj,bctgjp->bcgjpn", B, decay_in, xf)
    return y.reshape(b, nc, c, h, p), S.reshape(b, nc, h, p, n)


def digest(*ts):
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(-1).view(
            __import__("torch").uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def k5_args(torch, K5, dev, dtype):
    """K5's inputs at the test's shape on ``dev``: x, B, C in ``dtype``
    (bf16: Mamba2-780M's served dtypes, the wgmma body), dt, cum f32."""
    import numpy as np
    x, dt, A, B, C = inputs(np)
    t = [torch.tensor(a, dtype=torch.float32, device=dev)
         for a in (x, dt, A, B, C)]
    x, dt, A, B, C = t
    nc = L_ // CHUNK + 1
    pad = nc * CHUNK - L_
    F = torch.nn.functional
    x, B, C = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    xc = x.reshape(1, nc, CHUNK, H_, P_).to(dtype).contiguous()
    dtc = dt.reshape(1, nc, CHUNK, H_).contiguous()
    cum = torch.cumsum(dtc * A, dim=2).contiguous()
    Bc = B.reshape(1, nc, CHUNK, 1, N_).to(dtype).contiguous()
    Cc = C.reshape(1, nc, CHUNK, 1, N_).to(dtype).contiguous()
    return xc, dtc, cum, Bc, Cc


def k5_repeat(torch, K5, args, calls):
    """(body, number of calls whose outputs differ bitwise from the
    first's, elements of the worst one that differ)."""
    first = [o.clone() for o in K5.ssd_chunk(*args)]
    body = K5.body_for(args[0], args[3], args[4])
    differ, worst = 0, 0
    k5_repeat.digests[body] = digest(*first)
    for _ in range(calls - 1):
        out = K5.ssd_chunk(*args)
        n = sum(int((a != b).sum()) for a, b in zip(out, first))
        differ += n > 0
        worst = max(worst, n)
    torch.cuda.synchronize()
    return body, differ, worst


k5_repeat.digests = {}


def misses(torch, got, want):
    """Elements beyond TOL, and the largest |got - want| among them."""
    bad = (got - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()
    err = (got - want).abs()[bad]
    return int(bad.sum()), float(err.max()) if err.numel() else 0.0


def step_errors(torch, card, cpu32, ref64):
    """max |step - f64| of the card's and the CPU's f32 steps."""
    out = {}
    for k in ref64:
        r = ref64[k]
        out[k] = dict(card=float((card[k].cpu().double() - r).abs().max()),
                      cpu_f32=float((cpu32[k].double() - r).abs().max()))
    return out


def cpu_child(args):
    """The CPU's f32 steps twice in a new process (the first calls of
    every op first), each against f64: which step moves."""
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_chunk as K5
    if args.threads:
        torch.set_num_threads(args.threads)
    arrs = inputs(np)
    cpu = [torch.tensor(a, dtype=torch.float32) for a in arrs]
    first = parts(torch, K5, *cpu)
    second = parts(torch, K5, *cpu)
    ref64 = parts(torch, K5, *[torch.tensor(a, dtype=torch.float64)
                               for a in arrs])
    out = dict(threads=torch.get_num_threads(),
               capability=torch.backends.cpu.get_cpu_capability(),
               steps={})
    for k in ref64:
        out["steps"][k] = dict(
            first=float((first[k].double() - ref64[k]).abs().max()),
            second=float((second[k].double() - ref64[k]).abs().max()),
            same=bool(torch.equal(first[k], second[k])))
    out["y_miss_first"] = misses(torch, first["y"], second["y"])[0]
    return out


def ops_child(args):
    """The plain K5's three products, each called twice in a row in a new
    process (after a warm-up product first with ``--warm``): which one's
    first call differs from its second."""
    import numpy as np
    import torch
    if args.warm:
        a = torch.ones(8, 64, 64)
        torch.bmm(a, a)
    arrs = inputs(np)
    x, dt, A, B, C = (torch.tensor(a, dtype=torch.float32) for a in arrs)
    nc = -(-L_ // CHUNK)
    pad = nc * CHUNK - L_
    F = torch.nn.functional
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    xf = x.reshape(1, nc, CHUNK, 1, H_, P_)
    Bf = B.reshape(1, nc, CHUNK, 1, N_)
    Cf = C.reshape(1, nc, CHUNK, 1, N_)
    dtf = dt.reshape(1, nc, CHUNK, 1, H_)
    cum = torch.cumsum(dtf * A.view(1, 1, 1, 1, H_), dim=2)
    diff = cum[:, :, :, None] - cum[:, :, None, :]
    causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    w = torch.exp(diff.masked_fill(~causal[:, :, None, None], float("-inf")))
    ops = dict(
        scores=lambda: torch.einsum("bcsgn,bctgn->bcstg", Cf, Bf),
        y=lambda: torch.einsum("bcstgj,bctgj,bctgjp->bcsgjp", w, dtf, xf),
        states=lambda: torch.einsum("bctgn,bctgj,bctgjp->bcgjpn", Bf, dtf,
                                    xf))
    out = dict(threads=torch.get_num_threads(), warm=args.warm, ops={})
    for name, op in ops.items():
        first, second = op(), op()
        out["ops"][name] = dict(same=bool(torch.equal(first, second)),
                                max_diff=float((first - second).abs().max()))
    return out


# the plain K5's forms that `--plain-variants` runs first in new
# processes: the wrapper's plain version (einsums), `plain_matmul`, and
# `plain64` on f64 copies of the f32 inputs
VARIANTS = ("einsum", "matmul", "f64")


def plain_matmul(torch, x, dt, cum, B, C):
    """The plain K5 written with matmuls on permuted operands (no
    einsum): the candidate for the CPU route."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    hg = h // g
    f32 = torch.float32
    xg = x.to(f32).view(b, nc, c, g, hg, p).permute(0, 1, 3, 4, 2, 5)
    Bt = B.to(f32).permute(0, 1, 3, 2, 4)              # (b, nc, g, t, n)
    Ct = C.to(f32).permute(0, 1, 3, 2, 4)              # (b, nc, g, s, n)
    dtg = dt.view(b, nc, c, g, hg).permute(0, 1, 3, 4, 2)  # (.., hg, t)
    cg = cum.view(b, nc, c, g, hg).permute(0, 1, 3, 4, 2)
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cg[..., :, None] - cg[..., None, :]).masked_fill(
        ~causal, float("-inf")))                       # (.., hg, s, t)
    scores = torch.matmul(Ct, Bt.transpose(-1, -2))    # (b, nc, g, s, t)
    w = scores[:, :, :, None] * decay * dtg[..., None, :]
    y = torch.matmul(w, xg)                            # (.., hg, s, p)
    decay_in = torch.exp(cg[..., -1:] - cg) * dtg      # (.., hg, t)
    S = torch.matmul((xg * decay_in[..., None]).transpose(-1, -2),
                     Bt[:, :, :, None])                # (.., hg, p, n)
    return (y.permute(0, 1, 4, 2, 3, 5).reshape(b, nc, c, h, p),
            S.reshape(b, nc, h, p, n))


def chunked_inputs(torch, np, dtype):
    """K5's inputs of the test's shape on the CPU in ``dtype``, made as
    `ssd_chunked` makes them (padded, chunked, cum in ``dtype``)."""
    F = torch.nn.functional
    x, dt, A, B, C = (torch.tensor(a, dtype=dtype) for a in inputs(np))
    nc = -(-L_ // CHUNK)
    pad = nc * CHUNK - L_
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    dtc = dt.reshape(1, nc, CHUNK, H_).contiguous()
    return (x.reshape(1, nc, CHUNK, H_, P_).contiguous(), dtc,
            torch.cumsum(dtc * A, dim=2),
            B.reshape(1, nc, CHUNK, 1, N_).contiguous(),
            C.reshape(1, nc, CHUNK, 1, N_).contiguous())


def plain_child(args):
    """One plain K5 variant, first thing after the inputs in a new
    process, against f64: (elements beyond TOL of y, of the states)."""
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_chunk as K5
    a = chunked_inputs(torch, np, torch.float32)
    if args.variant == "einsum":
        got = K5.ssd_chunk_plain(*a)
    elif args.variant == "f64":
        got = plain64(torch, *(t.double() for t in a))
    else:
        got = plain_matmul(torch, *a)
    ref = torch.load(args.ref)
    out = dict(variant=args.variant, threads=torch.get_num_threads(),
               y_miss=misses(torch, got[0].double(), ref[0])[0],
               S_miss=misses(torch, got[1].double(), ref[1])[0],
               y_err=float((got[0].double() - ref[0]).abs().max()),
               S_err=float((got[1].double() - ref[1]).abs().max()))
    return out


def plain_variants(args):
    """``--plain-variants`` new processes, each running one of VARIANTS
    first, in turn, against an f64 reference made once."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    tmp = tempfile.mkdtemp()
    ref = os.path.join(tmp, "ref64.pt")
    torch.save(plain64(torch, *chunked_inputs(torch, np, torch.float64)),
               ref)
    runs = []
    for i in range(args.plain_variants):
        v = VARIANTS[i % len(VARIANTS)]
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--plain-child", "--variant", v, "--ref", ref,
                            "--src", args.src], capture_output=True,
                           text=True, timeout=600)
        if p.returncode:
            raise SystemExit(f"ssd_repeat: plain run {i} failed:\n"
                             f"{p.stdout}\n{p.stderr}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    shutil.rmtree(tmp)
    return {v: dict(runs=sum(r["variant"] == v for r in runs),
                    missed=sum(r["variant"] == v and (r["y_miss"] or
                                                      r["S_miss"])
                               for r in runs),
                    worst_y_err=max(r["y_err"] for r in runs
                                    if r["variant"] == v),
                    ok_y_err=min(r["y_err"] for r in runs
                                 if r["variant"] == v))
            for v in VARIANTS}


def cpu_fresh(args):
    """``--cpu-fresh`` new processes of `cpu_child` (half of them on one
    thread) and, with ``--ops``, as many of `ops_child` (half of them
    warmed up by one small product first)."""
    runs, op_runs = [], []
    for i in range(args.cpu_fresh if args.ops else 0):
        cmd = [sys.executable, os.path.abspath(__file__), "--ops-child",
               "--src", args.src] + (["--warm"] if i % 2 else [])
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if p.returncode:
            raise SystemExit(f"ssd_repeat: ops run {i} failed:\n"
                             f"{p.stdout}\n{p.stderr}")
        op_runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    for i in range(0 if args.ops else args.cpu_fresh):
        cmd = [sys.executable, os.path.abspath(__file__), "--cpu-child",
               "--src", args.src]
        if i % 2:
            cmd += ["--threads", "1"]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if p.returncode:
            raise SystemExit(f"ssd_repeat: cpu run {i} failed:\n"
                             f"{p.stdout}\n{p.stderr}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    if args.ops:
        return dict(runs=len(op_runs), by_op={
            name: dict(cold=sum(not r["ops"][name]["same"]
                                for r in op_runs if not r["warm"]),
                       warm=sum(not r["ops"][name]["same"]
                                for r in op_runs if r["warm"]),
                       max_diff=max(r["ops"][name]["max_diff"]
                                    for r in op_runs))
            for name in op_runs[0]["ops"]})
    bad = [r for r in runs
           if not all(v["same"] for v in r["steps"].values())]
    return dict(runs=len(runs), first_call_differs=len(bad),
                by_threads={t: sum(r["threads"] == t for r in bad)
                            for t in sorted({r["threads"] for r in runs})},
                bad=bad[:4])


def run(args):
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_chunk as K5
    from repro_torch.models.mamba import ssd_chunked
    if not torch.cuda.is_available():
        raise SystemExit("ssd_repeat: needs a CUDA device")
    dev = torch.device("cuda")
    if args.sanitize:
        for dtype in (torch.float32, torch.bfloat16):
            a = k5_args(torch, K5, dev, dtype)
            K5.ssd_chunk(*a)
            torch.cuda.synchronize()
            print(f"ssd_repeat --sanitize: {K5.body_for(a[0], a[3], a[4])} "
                  "body ran", flush=True)
        return None
    arrs = inputs(np)
    cpu = [torch.tensor(a, dtype=torch.float32) for a in arrs]
    card = [t.to(dev) for t in cpu]
    want_y, want_S = ssd_chunked(*cpu, chunk=CHUNK)
    refs = {}

    def steps_of(i):
        """The card's steps against f64 and the CPU's f32 (made once)."""
        if not refs:
            refs["cpu32"] = parts(torch, K5, *cpu)
            refs["ref64"] = parts(torch, K5, *[
                torch.tensor(a, dtype=torch.float64) for a in arrs])
        steps = parts(torch, K5, *card)
        return steps, step_errors(torch, steps, refs["cpu32"],
                                  refs["ref64"])
    k5_f32 = k5_args(torch, K5, dev, torch.float32)
    k5_bf16 = k5_args(torch, K5, dev, torch.bfloat16)
    first = None
    rows, missed, k5 = [], [], {}
    t0 = time.perf_counter()
    for i in range(args.repeats):
        y, S = ssd_chunked(*card, chunk=CHUNK)
        y, S = y.cpu(), S.cpu()
        if first is None:
            first = (y.clone(), S.clone())
        same = torch.equal(y, first[0]) and torch.equal(S, first[1])
        my, ey = misses(torch, y, want_y)
        ms, es = misses(torch, S, want_S)
        if (i == 0 and not args.child) or my or ms or not same:
            steps, errs = steps_of(i)
            rows.append(dict(run=i, y_miss=my, y_miss_max=ey, S_miss=ms,
                             S_miss_max=es, bitwise_first=same,
                             steps_vs_f64=errs,
                             steps_y_is_ssd_chunked=bool(torch.equal(
                                 steps["y"].cpu(), y))))
        if my or ms:
            missed.append(i)
        for name, a in (("cuda_core_f32", k5_f32), ("wgmma_bf16", k5_bf16)):
            body, differ, worst = k5_repeat(torch, K5, a, args.k5_calls)
            d = k5.setdefault(name, dict(body=body, calls=0, differ=0,
                                         worst_elements=0))
            d["calls"] += args.k5_calls
            d["differ"] += differ
            d["worst_elements"] = max(d["worst_elements"], worst)
    return dict(src=args.src, repeats=args.repeats, missed=missed,
                digest_y_S=digest(*first), digest_k5=k5_repeat.digests,
                runs_not_bitwise_first=sum(not r["bitwise_first"]
                                           for r in rows),
                rows=rows, k5=k5, seconds=time.perf_counter() - t0,
                device=torch.cuda.get_device_name(0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--fresh", type=int, default=0,
                    help="new processes, one run each")
    ap.add_argument("--k5-calls", type=int, default=5,
                    help="K5 calls a body a run, held bitwise")
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out")
    ap.add_argument("--cpu-fresh", type=int, default=0,
                    help="new processes that compute the CPU's f32 steps "
                    "twice, the first call first")
    ap.add_argument("--cpu-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ops", action="store_true",
                    help="with --cpu-fresh: the plain K5's products one "
                    "at a time")
    ap.add_argument("--ops-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--warm", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--plain-variants", type=int, default=0,
                    help="new processes, each running one plain K5 "
                    "variant first against f64")
    ap.add_argument("--plain-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--variant", default="einsum", help=argparse.SUPPRESS)
    ap.add_argument("--ref", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.plain_child:
        print(json.dumps(plain_child(args)), flush=True)
        return 0
    if args.plain_variants:
        print(json.dumps(plain_variants(args)), flush=True)
        return 0
    if args.ops_child:
        print(json.dumps(ops_child(args)), flush=True)
        return 0
    if args.cpu_child:
        print(json.dumps(cpu_child(args)), flush=True)
        return 0
    if args.cpu_fresh:
        print(json.dumps(cpu_fresh(args)), flush=True)
        return 0
    out = run(args)
    if out is None:
        return 0
    fresh = []
    for i in range(args.fresh):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--repeats", "1", "--child", "--k5-calls",
                            str(args.k5_calls), "--src", args.src],
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            raise SystemExit(f"ssd_repeat: fresh run {i} failed:\n"
                             f"{p.stdout}\n{p.stderr}")
        fresh.append(json.loads(p.stdout.strip().splitlines()[-1]))
    if fresh:
        out["fresh"] = dict(
            runs=len(fresh), missed=sum(bool(f["missed"]) for f in fresh),
            y_S_not_bitwise_this_process=sum(
                f["digest_y_S"] != out["digest_y_S"] for f in fresh),
            k5_not_bitwise_this_process=sum(
                f["digest_k5"] != out["digest_k5"] for f in fresh),
            k5_differ={k: sum(f["k5"][k]["differ"] for f in fresh)
                       for k in out["k5"]},
            rows=[f["rows"] for f in fresh if f["rows"]])
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

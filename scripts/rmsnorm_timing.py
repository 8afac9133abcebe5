"""Time the port's fused RMSNorm kernels (K4a, K4b) on one NVIDIA GPU:
the geometry of the vector body, the wrapper's host cost a call, and
the kernel's device time in the ways the serving path sees it.

    python scripts/rmsnorm_timing.py --sweep       # geometry candidates
    python scripts/rmsnorm_timing.py --host [--src DIR/src]
    python scripts/rmsnorm_timing.py --reconcile   # decode-row device time
    python scripts/rmsnorm_timing.py --bwd_sweep   # the backward's geometry

- ``--sweep``: for each shape of the serving path (bf16 x and weight),
  every geometry the kernel takes from a set of candidates (threads a
  row, rows a block, vectors a thread, grid), each checked against the
  plain version (rtol 1e-2, atol 1e-3) and timed: device us a launch
  (torch.profiler, mean of the records kept) and ms a call by CUDA
  events (20 back-to-back calls, median of 5). These back the
  constants of `_plan` in ``src/repro_torch/kernels/rmsnorm.py``.
- ``--host``: the wrapper's steps at a decode step's (1, 2560), each
  alone, by ``time.perf_counter`` over runs of 2,000 calls, the steps
  taken in turn for 15 rounds (the host's slow spells then fall on
  every step alike; the minimum and the median over the rounds): the
  checks, the entry's binding, the outputs' allocation, the stream
  handle, the ctypes call without a launch (R = 0 returns at once) and
  with it, and the whole wrapper. Works on this checkout and on one
  from before the call path was cut (``--src``), whose steps it names
  by that version's functions.
- ``--reconcile``: K4b at (1, 2560): device us a launch back to back,
  with the card idle 0.5 ms between launches, and idle with L2 evicted
  first, each with nvidia-smi's SM clock sampled every 20 ms.

- ``--bwd_sweep``: the backward kernel (K4a-bwd, K4b-bwd) at the train
  phase's shapes (bf16 (4096, 2560) with and without the residual and its
  gradient, the q- and k-norms' (131072, 128) and (32768, 128)), every
  vector-body geometry of a candidate set, each checked against the plain
  backward (rtol 1e-2, atol 1e-3) and timed as ``--sweep`` times the
  forward, with the bytes a call moves (x, r, g, gr read, dx written).
  These back the ``BWD_*`` constants of `_bwd_plan`.

Prints JSON lines, the card's name and power limit first, and appends
them to ``<out>/rmsnorm_<mode>.jsonl`` too (``--out``, by default
``build/timing``). Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (its timers; it imports no JAX)
TOL = dict(rtol=1e-2, atol=1e-3)   # chip_smoke.KERNEL_TOL["rmsnorm"]
MODES = ("sweep", "host", "reconcile", "bwd_sweep")


class Timer:
    """chip_smoke's timers: ms a call by CUDA events (back to back) and
    device us a call by torch.profiler."""

    def __init__(self, torch):
        self.torch = torch

    def events_ms(self, fn, reps=20, trials=5):
        return cs.time_ms(self.torch, fn, reps=reps, trials=trials)

    def device_us(self, fn):
        return 1e3 * (cs.device_ms(self.torch, fn) or 0.0)


def spaced_device_us(torch, fn, between, reps=200):
    """Device us of the RMSNorm kernels' launches in ``fn``, ``between``
    run before each call (torch.profiler, mean of the records kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            between()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "rmsnorm" in e.key]
    return (sum(e.self_device_time_total for e in rows)
            / max(1, sum(e.count for e in rows)))


def within(torch, got, want):
    g, w = got.float(), want.float()
    lim = TOL["atol"] + TOL["rtol"] * w.abs()
    return float(((g - w).abs() / lim).max())


def candidates(RN, R, D, n_sms):
    """Geometries the vector body takes for bf16 (R, D), deduplicated."""
    nv, out = D // 8, set()
    if nv <= 32:
        for G in (16, 8, 4):
            vpt = -(-nv // G)
            if G > nv * 2 or vpt not in RN.VECTORS:
                continue
            for threads in (128, 256, 512, 1024):
                if threads > RN.max_threads(vpt):
                    continue
                rows = threads // G
                full = -(-R // rows)
                for grid in {full, min(full, 8 * n_sms),
                             min(full, 16 * n_sms)}:
                    out.add((G, rows, vpt, grid))
        return sorted(out)
    for v in RN.VECTORS:
        G = -(-(-(-nv // v)) // 32) * 32
        vpt = next((u for u in RN.VECTORS if u * G >= nv), None)
        if vpt is None or G > RN.max_threads(vpt):
            continue
        for rows in (1, 2, 4):
            if G * rows > min(1024, RN.max_threads(vpt)) or rows > R:
                continue
            full = -(-R // rows)
            for grid in {full, min(full, 4 * n_sms)}:
                out.add((G, rows, vpt, grid))
    return sorted(out)


def mode_sweep(torch, RN, T, emit):
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    shapes = [("rmsnorm", 2048, 2560), ("rmsnorm_residual", 2048, 2560),
              ("rmsnorm", 65536, 128), ("rmsnorm", 16384, 128),
              ("rmsnorm", 2000, 3072), ("rmsnorm_residual", 2048, 1536),
              ("rmsnorm", 1024, 5120), ("rmsnorm", 512, 2560),
              ("rmsnorm", 264, 2560), ("rmsnorm", 1056, 2560),
              ("rmsnorm", 1, 2560), ("rmsnorm_residual", 1, 2560),
              ("rmsnorm", 1, 5120), ("rmsnorm", 32, 128),
              ("rmsnorm", 8, 128), ("rmsnorm_residual", 48, 2560)]
    best = {}
    for kernel, R, D in shapes:
        x = torch.randn(R, D, generator=gen, device=dev).to(bf16)
        r = torch.randn(R, D, generator=gen, device=dev).to(bf16)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf16)
        res = kernel == "rmsnorm_residual"
        want = (RN.rmsnorm_residual_plain(x, r, w)[0] if res
                else RN.rmsnorm_plain(x, w))
        y, s = torch.empty_like(x), torch.empty_like(x)
        ptrs = (x.data_ptr(), r.data_ptr() if res else 0, w.data_ptr(),
                y.data_ptr(), s.data_ptr() if res else 0)
        stream = torch.cuda.current_stream().cuda_stream
        default = RN._plan(R, D, bf16, bf16, True, n_sms)
        for G, rows, vpt, grid in candidates(RN, R, D, n_sms):
            plan = RN.Plan("vector", G, rows, vpt, grid)
            words = (R, D, 1, 1, vpt, G, rows, grid)

            def call(words=words):
                RN._build.launch_check(
                    RN._entry()(*ptrs, *words, 1e-6, stream), kernel)
            y.zero_()
            call()
            use = within(torch, y, want)
            row = dict(kernel=kernel, R=R, D=D, G=G, rows=rows, vpt=vpt,
                       grid=grid, default=plan == default, tol_use=use,
                       device_us=T.device_us(call),
                       events_ms=T.events_ms(call))
            emit(row, quiet=True)
            if use > 1.0:
                emit(dict(error="beyond the limit", **row))
            key = (kernel, R, D)
            if key not in best or row["device_us"] < best[key]["device_us"]:
                best[key] = row
            if row["default"]:
                best[key + ("default",)] = row
        F = torch.nn.functional
        lib = (lambda: F.rms_norm(torch.add(x, r), (D,), w, eps=1e-6)) \
            if res else (lambda: F.rms_norm(x, (D,), w, eps=1e-6))
        emit(dict(kernel=kernel, R=R, D=D, best=best[(kernel, R, D)],
                  default=best.get((kernel, R, D, "default")),
                  library_us=T.device_us(lib),
                  bytes=2 * D * R * (4 if res else 2) + 2 * D))


def bwd_candidates(RN, R, D, n_sms):
    """Geometries the backward's vector body takes for bf16 (R, D):
    (G, rows a block, vectors a thread, grid), deduplicated."""
    nv, out = D // 8, set()
    if nv <= 32:
        G = 1 << (nv - 1).bit_length()
        for threads in (128, 256, 512, 1024):
            rows = threads // G
            full = -(-R // rows)
            for k in (1, 2, 4, 8, 16):
                out.add((G, rows, 1, min(full, k * n_sms)))
        return sorted(out)
    for vpt in RN.BWD_VECTORS:
        G = -(-(-(-nv // vpt)) // 32) * 32
        if G > RN.bwd_max_threads(vpt):
            continue
        for rows in (1, 2, 3, 4, 6):
            if G * rows > RN.bwd_max_threads(vpt):
                continue
            full = -(-R // rows)
            for k in (1, 2, 3, 4, 8):
                out.add((G, rows, vpt, min(full, k * n_sms)))
    return sorted(out)


def mode_bwd_sweep(torch, RN, T, emit):
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    # (name, R, D, residual, the residual's gradient)
    shapes = [("rmsnorm_residual_backward", 4096, 2560, True, True),
              ("rmsnorm_residual_backward", 4096, 2560, True, False),
              ("rmsnorm_backward", 4096, 2560, False, False),
              ("rmsnorm_backward", 131072, 128, False, False),
              ("rmsnorm_backward", 32768, 128, False, False)]
    fn = RN._build.c_entry("rmsnorm_bwd", "rmsnorm_backward",
                           RN._BWD_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    for name, R, D, res, with_gres in shapes:
        x, g, r, gr = (torch.randn(R, D, generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf16)
        r = r if res else None
        gr = gr if with_gres else None
        want = (RN.rmsnorm_residual_backward_plain(x, r, w, g, gr) if res
                else RN.rmsnorm_backward_plain(x, w, g))
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        default = RN._bwd_plan(R, D, bf16, True, n_sms)
        n_bytes = 2 * R * D * (3 + int(res) + int(with_gres)) + 4 * D
        best = None
        for G, rows, vpt, grid in bwd_candidates(RN, R, D, n_sms):
            part = torch.empty(grid, D, dtype=torch.float32, device=dev)
            ptrs = (x.data_ptr(), 0 if r is None else r.data_ptr(),
                    w.data_ptr(), g.data_ptr(),
                    0 if gr is None else gr.data_ptr(), dx.data_ptr(),
                    dw.data_ptr(), part.data_ptr())
            words = (R, D, 1, 1, vpt, G, rows, grid)

            def call(ptrs=ptrs, words=words):
                RN._build.launch_check(fn(*ptrs, *words, 1e-6, stream),
                                       name)
            dx.zero_()
            call()
            use = max(within(torch, a, b) for a, b in zip((dx, dw), want))
            plan = RN.Plan("vector", G, rows, vpt, grid)
            row = dict(kernel=name, R=R, D=D, G=G, rows=rows, vpt=vpt,
                       grid=grid, default=plan == default, tol_use=use,
                       device_us=T.device_us(call),
                       events_ms=T.events_ms(call), bytes=n_bytes)
            emit(row, quiet=True)
            if use > 1.0:
                emit(dict(error="beyond the limit", **row))
            if best is None or row["events_ms"] < best["events_ms"]:
                best = row
            if row["default"]:
                emit(dict(default=row))
        emit(dict(kernel=name, R=R, D=D, best=best,
                  bound_us=1e6 * n_bytes / cs.HBM_BYTES_PER_S))


def mode_host(torch, RN, B, T, emit, n=2000, rounds=15):
    import ctypes
    bf16 = torch.bfloat16
    R, D = 1, 2560
    x = torch.randn(R, D, device="cuda").to(bf16)
    dev = x.device
    r = torch.randn(R, D, device=dev).to(bf16)
    w = torch.ones(D, device=dev, dtype=bf16)
    y, s = torch.empty_like(x), torch.empty_like(x)
    F = torch.nn.functional
    new = hasattr(RN, "_plan")
    ptrs = (x.data_ptr(), r.data_ptr(), w.data_ptr(), y.data_ptr(),
            s.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if new:
        fn = RN._entry()
        plan = RN._plan(R, D, bf16, bf16, True, 132)
        geo = (plan.vectors_per_thread, plan.threads_per_row,
               plan.rows_per_block, plan.grid)
        args = ptrs + (R, D, 1, 1) + geo + (1e-6, stream)
        no_launch = args[:5] + (0,) + args[6:]
        lib = B.load_library("rmsnorm")
        pyfn = getattr(ctypes.PyDLL(lib._name), "rmsnorm")
        pyfn.argtypes, pyfn.restype = RN._ARGTYPES, ctypes.c_int
    else:
        fn = B.c_entry("rmsnorm", "rmsnorm", RN._ARGTYPES)
        args = (1, 1, ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], R, D,
                1e-6, stream)
        no_launch = args[:7] + (0,) + args[8:]
    steps = {
        "wrapper K4b": lambda: RN.rmsnorm_residual(x, r, w),
        "wrapper K4a": lambda: RN.rmsnorm(x, w),
        "empty_like x1": lambda: torch.empty_like(x),
        "empty_like x2": lambda: (torch.empty_like(x),
                                  torch.empty_like(x)),
        "empty (2, ...) unbind": lambda: torch.empty(
            (2,) + tuple(x.shape), dtype=x.dtype, device=dev).unbind(0),
        "x.new_empty(x.shape)": lambda: x.new_empty(x.shape),
        "x.device": lambda: x.device,
        "data_ptr x5": lambda: (x.data_ptr(), r.data_ptr(), w.data_ptr(),
                                y.data_ptr(), s.data_ptr()),
        "current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes call, no launch (R = 0)": lambda: fn(*no_launch),
        "ctypes call + launch": lambda: fn(*args),
        "torch.add": lambda: torch.add(x, r),
        "F.rms_norm": lambda: F.rms_norm(x, (D,), w, eps=1e-6),
    }
    if new:
        steps.update({
            "_check_inputs (K4b)":
                lambda: RN._check_inputs("k", x, r, w),
            "_entry": RN._entry,
            "_words (cached plan)": lambda: RN._words(R, D, bf16, bf16,
                                                      True, 0),
            "stream_of (raw)": lambda: B.stream_of(0),
            "PyDLL call + launch": lambda: pyfn(*args),
        })
    else:
        steps.update({
            "check_tensor x3": lambda: (
                B.check_tensor("x", x, RN.DTYPES, dev),
                B.check_tensor("r", r, (x.dtype,), dev),
                B.check_tensor("w", w, RN.DTYPES, dev, ndim=1)),
            "_check_inputs (K4b)":
                lambda: RN._check_inputs("k", x, r, w),
            "c_entry": lambda: B.c_entry("rmsnorm", "rmsnorm",
                                         RN._ARGTYPES),
            "require_cuda": lambda: B.require_cuda("k", dev),
            "stream_of": lambda: B.stream_of(dev),
        })
    runs = {name: [] for name in steps}
    for f in steps.values():
        for _ in range(200):
            f()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, f in steps.items():
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            runs[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    for name, us in runs.items():
        emit(dict(step=name, host_us_min=min(us),
                  host_us_median=statistics.median(us),
                  host_us_max=max(us), version="cut" if new else "parent"))
    emit(dict(step="events K4b (1, 2560)", events_ms=T.events_ms(
        lambda: RN.rmsnorm_residual(x, r, w), reps=200, trials=7),
        version="cut" if new else "parent"))


def mode_reconcile(torch, RN, emit):
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    x = torch.randn(1, 2560, device=dev).to(bf16)
    r = torch.randn(1, 2560, device=dev).to(bf16)
    w = torch.ones(2560, device=dev, dtype=bf16)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    call = lambda: RN.rmsnorm_residual(x, r, w)   # noqa: E731

    def idle():
        torch.cuda.synchronize()
        time.sleep(0.0005)

    def idle_cold():
        flush.fill_(1.0)
        idle()
    for name, between in (("back to back", lambda: None),
                          ("idle 0.5 ms before each", idle),
                          ("idle, L2 evicted", idle_cold),
                          ("back to back again", lambda: None)):
        with cs.SmClock() as clk:
            us = spaced_device_us(torch, call, between)
        emit(dict(case=name, device_us=us, sm_clock_mhz=clk.summary()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--out", default=os.path.join(REPO, "build", "timing"))
    for m in MODES:
        ap.add_argument(f"--{m}", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import _build as B
    from repro_torch.kernels import rmsnorm as RN
    if not torch.cuda.is_available():
        print("rmsnorm_timing: no CUDA device", file=sys.stderr)
        return 3
    os.makedirs(args.out, exist_ok=True)
    T = Timer(torch)
    modes = [m for m in MODES if getattr(args, m)]
    for mode in modes:
        path = os.path.join(args.out, f"rmsnorm_{mode}.jsonl")
        with open(path, "a") as f:
            def emit(obj, quiet=False):
                obj = dict(mode=mode, src=os.path.abspath(args.src), **obj)
                f.write(json.dumps(obj) + "\n")
                if not quiet:
                    print(json.dumps(obj), flush=True)
            emit(dict(card=cs.smi_line()))
            B.build(("rmsnorm", "rmsnorm_bwd"))
            {"sweep": lambda: mode_sweep(torch, RN, T, emit),
             "bwd_sweep": lambda: mode_bwd_sweep(torch, RN, T, emit),
             "host": lambda: mode_host(torch, RN, B, T, emit),
             "reconcile": lambda: mode_reconcile(torch, RN, emit)}[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py                      # the full check, one card
    python3 chip_smoke.py --n-requests 60000   # the paper's full trace
    python3 chip_smoke.py --profile            # + a torch.profiler phase

Phases, each printing one JSON line; any failure exits non-zero:

1. ``device``    the card's name and power limit (nvidia-smi).
2. ``build``     nvcc builds every kernel source of ``src/repro_torch/csrc``
                 into ``build/kernels/`` (seconds, ptxas report).
3. ``kernel``    each kernel against its plain PyTorch version on the
                 card, at the main path's shapes and beyond: index
                 exact, f32 weight within rtol 1e-6, f64 bitwise; times
                 (CUDA events) for the kernel, the plain version and
                 the bound.
4. ``main_path`` `repro_torch.api.run_experiment` on the paper's Fig. 5
                 grid (F = 200 functions, Azure-like requests, ESFF,
                 C = 8..32: seven lanes), with the kernels' launch
                 counts set to 0 just before and read just after; the
                 results are held against the JAX package's own (the
                 constants below). The trace is cut from the paper's
                 60,000 requests to 30,000 (`benchmarks/common.py`'s
                 default): the eager event loop is launch-bound, and
                 60,000 would take most of the run's time limit.
5. ``parity``    the same spec at N = 2,000 on the card and on the CPU.
6. ``profile``   (``--profile`` only) torch.profiler over a short run:
                 device busy share and the kernels' device times.

Then the card's name and power limit as nvidia-smi prints them, one
``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The JAX package's results for the main path's spec, regenerated on
# the CPU with (PYTHONPATH=src, JAX_PLATFORMS=cpu):
#   from repro.api import ExperimentSpec, SyntheticTrace, run_experiment
#   src = SyntheticTrace.make(n_functions=200, n_requests=N, seed=0,
#       utilization=0.2, exec_median=0.1, exec_sigma=1.4, burst_frac=0.3)
#   rs = run_experiment(ExperimentSpec(traces=[src], policies=("esff",),
#       capacities=(8, 12, 16, 20, 24, 28, 32), queue_cap=4096))
#   {k: rs[k][0, 0, :, 0].tolist() for k in rs.metrics}   # repr floats
# and n_events from repro.core.jax_engine._simulate on the same lanes
# (it is n_requests + cold_starts: one arrival, one completion per
# request, one cold-done per cold start).
CAPACITIES = (8, 12, 16, 20, 24, 28, 32)
EXPECTED = {
    60000: {
        "done": [60000] * 7, "overflow": [0] * 7, "stalled": [0] * 7,
        "cold_starts": [9423, 14137, 17843, 16405, 15296, 14703, 14359],
        "evictions": [9415, 14125, 17827, 16385, 15272, 14675, 14327],
        "n_events": [129423, 134137, 137843, 136405, 135296, 134703,
                     134359],
        "mean_response": [143.78454297076706, 52.45100160552744,
                          4.230609046076287, 1.4971670603323834,
                          1.2750254489707686, 1.1734215412632854,
                          1.1703959354039148],
        "mean_slowdown": [854.6009082847161, 327.1091848107679,
                          41.07946092393565, 20.861325222135303,
                          15.671335892000945, 13.41032052525046,
                          12.78277794792688],
        "max_response": [3415.331204672056, 3077.6253492575997,
                         555.796439412451, 76.55581702542122,
                         16.471047930082023, 8.393050979419513,
                         4.916179406674928],
    },
    30000: {
        "done": [30000] * 7, "overflow": [0] * 7, "stalled": [0] * 7,
        "cold_starts": [5229, 7667, 9764, 8926, 8330, 8022, 7814],
        "evictions": [5221, 7655, 9748, 8906, 8306, 7994, 7782],
        "n_events": [65229, 67667, 69764, 68926, 68330, 68022, 67814],
        "mean_response": [88.60186846894098, 35.52233884090608,
                          3.730139683524422, 1.4171491405443895,
                          1.2464849243290084, 1.2123480372516626,
                          1.192458003033613],
        "mean_slowdown": [740.6544979220394, 311.0606409123218,
                          36.06815591525324, 19.72626758493041,
                          15.813160391982638, 14.059284743713494,
                          13.15188591046504],
        "max_response": [1801.3315051097882, 1597.6201583096656,
                         483.9878575462176, 9.19898387422245,
                         5.21228674725964, 5.216760139215808,
                         5.1412160224715535],
    },
}
TRACE_KW = dict(utilization=0.2, exec_median=0.1, exec_sigma=1.4,
                burst_frac=0.3)
RTOL = 1e-9

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 and f64 rates outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps: int = 200, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(20):
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


def bound_ms(n_bytes: int, n_ops: int, kind: str):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ------------------------------------------------------------ phase 3
def frp_inputs(np, F, seed, *, lanes=None):
    """Random FRP inputs in the ranges of tests/test_kernels.py."""
    r = np.random.default_rng(seed)
    shape = (F,) if lanes is None else (lanes, F)
    return dict(t_e=r.uniform(0.001, 10, shape), t_l=r.uniform(0.5, 1.5,
                shape), t_v=r.uniform(0.5, 1.5, shape),
                n_w=r.integers(0, 5, shape), K=r.integers(0, 3, shape))


def phase_kernel(torch, np, fs):
    dev = torch.device("cuda")
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    res = {"phase": "kernel", "f32": [], "lanes": None}

    # f32 contract (the TPU kernel's own): random rows, an all-invalid
    # row and a tie
    cases = []
    for F, seed in ((200, 0), (65536, 1)):
        a = frp_inputs(np, F, seed)
        cases.append((f"random F={F}", a, 1.0, 3))
    a = frp_inputs(np, 200, 2)
    a["n_w"][:] = 0
    cases.append(("all invalid F=200", a, 1.0, 3))
    a = frp_inputs(np, 200, 3)
    a["n_w"][:] = 0
    for f in (17, 42, 150):   # three identical valid candidates
        a["t_e"][f], a["t_l"][f], a["t_v"][f] = 2.0, 1.0, 1.0
        a["n_w"][f], a["K"][f] = 3, 1
    cases.append(("tie F=200", a, 1.0, 3))
    for name, a, tv_j, self_idx in cases:
        args = [torch.tensor(a[k], dtype=f32, device=dev)
                for k in ("t_e", "t_l", "t_v")]
        args += [torch.tensor(a[k], dtype=i32, device=dev)
                 for k in ("n_w", "K")]
        kw, ki = fs.frp_select(*args, tv_j, self_idx)
        pw, pi = fs.frp_select_plain(*args, tv_j, self_idx)
        torch.cuda.synchronize()
        kw, ki, pw, pi = float(kw), int(ki), float(pw), int(pi)
        need(ki == pi, f"frp_select {name}: index {ki} != plain {pi}")
        if name.startswith("all invalid"):
            need(ki == -1, f"frp_select {name}: index {ki} != -1")
        if name.startswith("tie"):
            need(ki == 17, f"frp_select {name}: index {ki} != 17")
        if ki >= 0:
            need(math.isclose(kw, pw, rel_tol=1e-6, abs_tol=0.0),
                 f"frp_select {name}: weight {kw!r} vs plain {pw!r}")
        row = dict(case=name, index=ki, weight=kw,
                   abs_err=abs(kw - pw) if ki >= 0 else 0.0)
        if name.startswith("random"):
            F = a["t_e"].shape[0]
            b, by = bound_ms(F * 20 + 8, F * 15, "f32")
            row.update(ms=time_ms(torch, lambda: fs.frp_select(
                *args, tv_j, self_idx)),
                plain_ms=time_ms(torch, lambda: fs.frp_select_plain(
                    *args, tv_j, self_idx)),
                bound_ms=b, bound_by=by)
        res["f32"].append(row)

    # f64 engine contract at the main path's shape (7 lanes x F = 200)
    L, F = len(CAPACITIES), 200
    a = frp_inputs(np, F, 4, lanes=L)
    r = np.random.default_rng(5)
    jc = r.integers(0, F, L)
    lanes = [torch.tensor(a[k], dtype=f64, device=dev)
             for k in ("t_e", "t_l", "t_v")]
    lanes += [torch.tensor(a[k], dtype=i32, device=dev)
              for k in ("n_w", "K")]
    lanes += [lanes[2][torch.arange(L, device=dev),
                       torch.tensor(jc, device=dev)].contiguous(),
              torch.tensor(jc, dtype=i32, device=dev),
              torch.tensor(r.uniform(0.5, 2.0, L), dtype=f64, device=dev)]
    kw, ki = fs.frp_select_lanes(*lanes)
    pw, pi = fs.frp_select_lanes_plain(*lanes)
    torch.cuda.synchronize()
    need(torch.equal(ki, pi), f"frp_select_lanes: index {ki.tolist()} "
         f"!= plain {pi.tolist()}")
    need(torch.equal(kw, pw), "frp_select_lanes: weights not bitwise "
         f"equal to the plain version ({kw.tolist()} vs {pw.tolist()})")
    b, by = bound_ms(L * F * 32 + L * 32, L * F * 15, "f64")
    res["lanes"] = dict(
        shape=[L, F], index=ki.tolist(),
        max_abs_err=float((kw - pw).abs().max()),
        ms=time_ms(torch, lambda: fs.frp_select_lanes(*lanes)),
        plain_ms=time_ms(torch, lambda: fs.frp_select_lanes_plain(*lanes)),
        bound_ms=b, bound_by=by)
    res["library_ms"] = None
    res["library_note"] = "no single PyTorch call computes FRP selection"
    emit(res)
    return res


# --------------------------------------------------------- phases 4, 5
def fig5_spec(api, n_requests: int, device: str):
    src = api.SyntheticTrace.make(n_functions=200, n_requests=n_requests,
                                  seed=0, **TRACE_KW)
    return api.ExperimentSpec(traces=[src], policies=("esff",),
                              capacities=CAPACITIES, queue_cap=4096,
                              device=device)


def lane_values(rs, metric):
    return [rs.value(metric, capacity=c) for c in CAPACITIES]


def phase_main_path(torch, api, fs, n_requests):
    spec = fig5_spec(api, n_requests, "cuda")
    spec.expanded_traces()[0].arrays()   # trace generation is set-up
    fs.frp_select.launches = 0
    fs.frp_select_lanes.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = api.run_experiment(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"frp_select": fs.frp_select_lanes.launches}
    rs.check()
    got = {k: lane_values(rs, k) for k in
           ("done", "overflow", "stalled", "cold_starts", "evictions",
            "n_events", "mean_response", "mean_slowdown",
            "max_response")}
    need(all(d == n_requests for d in got["done"]),
         f"main_path: done {got['done']} != {n_requests}")
    need(launches["frp_select"] > 0,
         "main_path: frp_select_lanes was never launched")
    exp = EXPECTED.get(n_requests)
    mismatch, bitwise = [], exp is not None
    if exp is not None:
        for k, want in exp.items():
            for c, g, w in zip(CAPACITIES, got[k], want):
                bitwise &= g == w
                ok = (g == w if isinstance(w, int)
                      else math.isclose(g, w, rel_tol=RTOL, abs_tol=0.0))
                if not ok:
                    mismatch.append(f"{k}[C={c}]: {g!r} != {w!r}")
    events = sum(got["n_events"])
    steps = max(got["n_events"])
    emit(dict(phase="main_path", n_requests=n_requests,
              capacities=list(CAPACITIES), wall_s=wall,
              req_per_s=len(CAPACITIES) * n_requests / wall,
              n_events=got["n_events"], events_total=events,
              ms_per_event_step=1e3 * wall / steps,
              mean_response=got["mean_response"],
              cold_starts=got["cold_starts"], launches=launches,
              held_against_jax=exp is not None,
              bitwise_vs_jax=bitwise, mismatch=mismatch))
    need(not mismatch, "main_path: differs from the JAX package: "
         + "; ".join(mismatch))
    return launches


def phase_parity(np, api, n_requests=2000):
    t0 = time.perf_counter()
    card = api.run_experiment(fig5_spec(api, n_requests, "cuda"))
    t1 = time.perf_counter()
    cpu = api.run_experiment(fig5_spec(api, n_requests, "cpu"))
    t2 = time.perf_counter()
    bad, not_bitwise = [], []
    for k in sorted(cpu.data):
        a, b = card[k], cpu[k]
        if (a == b).all():
            continue
        if a.dtype.kind == "f" and np.allclose(a, b, rtol=RTOL, atol=0.0):
            not_bitwise.append(k)
        else:
            bad.append(k)
    emit(dict(phase="parity", n_requests=n_requests, card_s=t1 - t0,
              cpu_s=t2 - t1, metrics=sorted(cpu.data), failed=bad,
              within_rtol_not_bitwise=not_bitwise))
    need(not bad, f"parity: card and CPU differ in {bad}")


def phase_profile(torch, api, n_requests=300):
    """Device busy share of the eager event loop and the kernels'
    device times, from torch.profiler over a short main-path run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import SEG
    spec = fig5_spec(api, n_requests, "cuda")
    spec.expanded_traces()[0].arrays()
    api.run_experiment(spec)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs = api.run_experiment(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the loop runs whole segments of SEG steps until every lane is done
    steps = -(-int(rs["n_events"].max()) // SEG) * SEG
    # device-side rows only (kernels, copies): an aten op's row also
    # carries the device time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
    frp = [e for e in rows if "frp_select" in e.key]
    emit(dict(phase="profile", n_requests=n_requests, wall_s=wall,
              event_steps=steps, device_us_per_step=dev_us / steps,
              device_busy_s=dev_us * 1e-6,
              device_busy_share=dev_us * 1e-6 / wall,
              device_ops=launches, device_ops_per_step=launches / steps,
              frp_select_device_us=(frp[0].self_device_time_total
                                    / frp[0].count if frp else None),
              top=[dict(name=e.key[:80], count=e.count,
                        device_us=e.self_device_time_total)
                   for e in top],
              host_top=[dict(name=e.key[:60], count=e.count,
                             cpu_us=e.self_cpu_time_total)
                        for e in sorted(prof.key_averages(),
                                        key=lambda e:
                                        -e.self_cpu_time_total)[:15]]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-requests", type=int, default=30000,
                    help="main path trace length (the paper's is 60000)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import numpy as np
        import torch

        from repro_torch import api
        from repro_torch.kernels import _build
        from repro_torch.kernels import frp_select as fs
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    try:
        smi = smi_line()
        kind = torch.cuda.get_device_name(0)
        emit(dict(phase="device", name=kind, nvidia_smi=smi,
                  count=torch.cuda.device_count(),
                  torch=torch.__version__, cuda=torch.version.cuda))
        t0 = time.perf_counter()
        _build.build()
        emit(dict(phase="build", seconds=time.perf_counter() - t0,
                  sources=list(_build.SOURCES),
                  ptxas={k: v["ptxas"] for k, v in
                         _build.BUILD_INFO.items()}))
        kres = phase_kernel(torch, np, fs)
        launches = phase_main_path(torch, api, fs, args.n_requests)
        phase_parity(np, api)
        if args.profile:
            phase_profile(torch, api)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    lanes = kres["lanes"]
    kernels = [dict(
        name="frp_select", entry="frp_select_lanes", route="cuda",
        source="src/repro_torch/csrc/frp_select.cu",
        replaces="src/repro/kernels/sched_weights.py:68",
        launches=launches["frp_select"], max_abs_err=lanes["max_abs_err"],
        ms=lanes["ms"], plain_ms=lanes["plain_ms"],
        bound_ms=lanes["bound_ms"], bound_by=lanes["bound_by"],
        library_ms=None, check="passed")]
    emit(dict(phase="done", total_s=time.perf_counter() - t_start))
    print(smi, flush=True)
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())

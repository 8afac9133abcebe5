"""Time variants of the SSD kernel's (K5) tensor-core body against the
source as it stands, on one NVIDIA GPU: the measurements behind the
body's design choices.

    python scripts/ssd_variants.py

Each variant is ``csrc/ssd_chunk.cu`` with a few textual edits
(VARIANTS), built with the source's own nvcc flags into
``build/ssd_variants/``:
- ``rolled_scores``: the scores' k-steps in a loop kept rolled (``#pragma
  unroll 1``; its count stays a compile-time constant);
- ``two_blocks`` / ``three_blocks_n64``: the launch bounds of two blocks
  an SM at every n / of three at n = 64 (four there as built);
- ``tile_accumulator``: every tile of t sums its three passes into a
  fresh accumulator, added to the output's in f32 by the CUDA cores;
- ``fast_exp``: the weights' exponent by ``__expf``.
For the cases of `chip_smoke.SSD_CASES` that the wgmma body runs, every
variant is held against the plain version (``tol_use`` of
`chip_smoke.KERNEL_TOL`) and timed in turns with the others (CUDA
events, 20 calls, median of 7 trials) and by torch.profiler. Prints the
ptxas registers, spills and C7515 notes of each variant, one JSON line a
(case, variant), and the card's name and power limit. Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_SCORES = "#pragma unroll\n      for (int kk = 0; kk < 4 * NCH; ++kk) {"
_BOUNDS = ("constexpr int tc_blocks_per_sm(int nch) "
           "{ return nch == 1 ? 4 : 3; }")
_PASSES = """    wgmma_fence();
#pragma unroll
    for (int q = 2; q >= 0; --q)
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        Wgmma<64>::rs(acc, a[q][kj],"""
_TILE_PASSES = """    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int q = 2; q >= 0; --q)
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        Wgmma<64>::rs(part, a[q][kj],"""
_PASSES_END = """    wgmma_commit();
    wgmma_wait_all();
    pin<32>(acc);
"""
_TILE_END = """    wgmma_commit();
    wgmma_wait_all();
    pin<32>(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
"""
VARIANTS = {
    "as built": [],
    "rolled_scores": [(_SCORES, _SCORES.replace("unroll", "unroll 1"))],
    "two_blocks": [(_BOUNDS, "constexpr int tc_blocks_per_sm(int) "
                             "{ return 2; }")],
    "three_blocks_n64": [(_BOUNDS, "constexpr int tc_blocks_per_sm(int) "
                                   "{ return 3; }")],
    "tile_accumulator": [(_PASSES, _TILE_PASSES), (_PASSES_END, _TILE_END)],
    "fast_exp": [("v[e] * expf(cs - cum_s[t])",
                  "v[e] * __expf(cs - cum_s[t])")],
}


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_chunk as K5
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 3
    out_dir = os.path.join(ROOT, "build", "ssd_variants")
    os.makedirs(out_dir, exist_ok=True)
    base = (_build.CSRC / "ssd_chunk.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = base
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"ssd_variants: {name}: edit not found")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"variant{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"variant{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags("ssd_chunk"), "-I",
             str(_build.CSRC), "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        lines = cs.ptxas_lines(report, "ssd_chunk_wgmma_kernel")
        print(json.dumps(dict(
            variant=name, rc=proc.returncode,
            registers=[ln for ln in lines if "Used" in ln],
            spills=[ln for ln in lines if "spill" in ln],
            c7515=sum("C7515" in ln for ln in report.splitlines()))),
            flush=True)
        if proc.returncode != 0:
            print(report, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(lib).ssd_chunk
        fn.argtypes, fn.restype = K5._ARGTYPES, ctypes.c_int
        entries[name] = fn
    bf16 = torch.bfloat16
    tol = cs.KERNEL_TOL["ssd_chunk"]
    stream = _build.stream_of(torch.device("cuda"))
    for i, (case, shape, xd, bcd, valid, body) in enumerate(cs.SSD_CASES):
        if body != "wgmma":
            continue
        a = cs.ssd_inputs(torch, np, *shape, bf16, bf16, seed=i,
                          valid=valid)
        b, nc, c, h, p = a[0].shape
        g, n = a[3].shape[3], a[3].shape[4]
        py, ps = K5.ssd_chunk_plain(*a)
        calls, uses = {}, {}
        for name, fn in entries.items():
            y = torch.empty(b, nc, c, h, p, device="cuda")
            st = torch.empty(b, nc, h, p, n, device="cuda")

            def call(fn=fn, y=y, st=st):
                rc = fn(1, 1, 1, *(t.data_ptr() for t in (*a, y, st)),
                        b * nc, c, h, g, p, n, stream)
                if rc:
                    raise RuntimeError(f"ssd_chunk: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            calls[name] = call
            uses[name] = (cs._tol_use(y, py, tol), cs._tol_use(st, ps, tol))
        names = list(calls)
        ms = cs.time_in_turns(torch, [calls[k] for k in names], reps=20,
                              trials=7)
        for name, t in zip(names, ms):
            print(json.dumps(dict(
                case=case, variant=name, events_ms=t,
                device_ms=cs.device_ms(torch, calls[name]),
                tol_use_y=uses[name][0], tol_use_states=uses[name][1])),
                flush=True)
    print(json.dumps(dict(card=cs.smi_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

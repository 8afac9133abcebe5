"""No f32 in the compiled engine: a scan of K0's machine code.

Counterpart of `repro.analysis.hlo.audit_f32` (zero ``f32[`` in the
optimized HLO). On the card each event-loop library
(`repro_torch.kernels._build.EVENT_LOOP_UNITS`) is disassembled with
``cuobjdump -sass`` and every f32 arithmetic instruction (`F32_OPS`) is
counted a kernel. The engine computes in f64 only, so a hit is allowed
only where the CUDA toolkit's f64 library puts it, by routine:

* ``div.rn.f64`` (IEEE f64 division, `ALLOWED`): each inline call site
  tests the divisor's and the quotient's high 32-bit words as f32 bit
  patterns -- one ``FSETP`` against 6.58e-37, one ``FFMA Rd, RZ, a, b``
  (it reads ``b``'s class: zero times ``a`` plus ``b``) and one ``FSETP``
  against 1.47e-39 -- and calls the shared slow path
  (``__internal`` ``div_rn_f64_full``) when a test fails; that subroutine,
  once a kernel, makes six more high-word tests (three against 1.47e-39,
  two against zero, one between two words). None computes an f32 value.

A kernel's allowance is therefore exact: with ``n`` call sites (its
``CALL.REL`` to the slow path), ``n`` FFMA and ``2 n + 6`` FSETP of those
shapes, and no FADD, FMUL or FMNMX. Any other f32 instruction, or another
count, fails the gate. On the CPU the gate reports that it did not run
and why; on a card a missing ``cuobjdump`` or library fails it.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

F32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP")
_OP = re.compile(r"\b(FADD|FMUL|FFMA|FMNMX|FSETP)(?:32I)?(?:\.[A-Z0-9_.]*)?"
                 r"\s+([^;]*);")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_KERNEL = re.compile(r"(event_loop(?:_cluster)?_kernel)INS_6PolicyILi(\d)ELb"
                     r"(\d)ELb(\d)ELb(\d)EEELb(\d)E")
# the shapes of div.rn.f64's high-word tests (operands after the opcode)
_SHAPES = {
    "site_small": re.compile(r"\|R\d+\|(\.reuse)?, 6\.5827683646048100446e-37"),
    "min_normal": re.compile(r"\|R\d+\|(\.reuse)?, 1\.469367938527859385e-39"),
    "zero_test": re.compile(r"P\d, PT, R\d+(\.reuse)?, RZ, PT"),
    "word_test": re.compile(r"P\d, PT, \|R\d+\|(\.reuse)?, R\d+, PT"),
    "ffma_rz": re.compile(r"R\d+, RZ, (U?R\d+), R\d+"),
}
ALLOWED = {
    "div.rn.f64": "the CUDA toolkit's IEEE f64 division: a call site's "
                  "two FSETP and one FFMA RZ test the operands' and the "
                  "quotient's high words; its slow path, once a kernel, "
                  "six FSETP on high words. No f32 value is computed.",
}


def cuobjdump() -> Optional[str]:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def kernel_name(mangled: str) -> str:
    """A kernel's readable name: its form and policy template arguments,
    e.g. ``event_loop_cluster_kernel<0,0,1,0,true>``."""
    m = _KERNEL.search(mangled)
    if not m:
        return mangled
    form, *args, k = m.groups()
    return f"{form}<{','.join(args)},{'true' if k == '1' else 'false'}>"


def scan_sass(text: str) -> List[dict]:
    """Each kernel of a ``cuobjdump -sass`` listing: its f32 instruction
    counts (`F32_OPS`), its division call sites and how its hits split
    over the allowed shapes; ``allowed`` and ``problems`` say whether the
    counts are exactly `ALLOWED`'s."""
    heads = list(_FUNC.finditer(text))
    out = []
    for i, h in enumerate(heads):
        body = text[h.end():heads[i + 1].start() if i + 1 < len(heads)
                    else len(text)]
        counts = {op: 0 for op in F32_OPS}
        shapes = {k: 0 for k in _SHAPES}
        odd = []
        for m in _OP.finditer(body):
            op, operands = m.group(1), m.group(2)
            counts[op] += 1
            kinds = ([k for k in ("site_small", "min_normal", "zero_test",
                                  "word_test") if _SHAPES[k].search(operands)]
                     if op == "FSETP" else
                     ["ffma_rz"] if op == "FFMA" and _SHAPES["ffma_rz"].match(
                         operands) else [])
            if kinds:
                shapes[kinds[0]] += 1
            else:
                odd.append(f"{op} {operands.strip()}")
        sites = len(re.findall(r"\bCALL\.REL", body))
        want = dict(FADD=0, FMUL=0, FMNMX=0, FFMA=sites,
                    FSETP=2 * sites + (6 if sites else 0))
        want_shapes = dict(site_small=sites, ffma_rz=sites,
                           min_normal=sites + (3 if sites else 0),
                           zero_test=2 if sites else 0,
                           word_test=1 if sites else 0)
        name = kernel_name(h.group(1))
        problems = [f"{name}: {n} f32 {op} where div.rn.f64 accounts for "
                    f"{want[op]}" for op, n in counts.items()
                    if n != want[op]]
        problems += [f"{name}: f32 instruction of no allowed shape: {o}"
                     for o in odd[:5]]
        if not problems and shapes != want_shapes:
            problems.append(f"{name}: high-word tests {shapes}, "
                            f"div.rn.f64 with {sites} call sites makes "
                            f"{want_shapes}")
        out.append(dict(kernel=name, f32=counts, div_sites=sites,
                        allowed={"div.rn.f64": sum(want.values())},
                        problems=problems))
    return out


def audit_sass(device, units=None) -> Dict:
    """The gate on ``device``: not run on the CPU; on a card, build every
    event-loop unit and scan its library."""
    from repro_torch.kernels import _build
    units = tuple(units or _build.EVENT_LOOP_UNITS)
    if device.type != "cuda":
        return dict(entry="event_loop_units", passed=True, run=False,
                    reason="no CUDA device: K0's libraries are built and "
                           "disassembled only on a card (nvcc, cuobjdump)",
                    problems=[])
    tool = cuobjdump()
    if tool is None:
        return dict(entry="event_loop_units", passed=False, run=True,
                    problems=["cuobjdump not found (PATH, $CUDA_HOME/bin, "
                              "/usr/local/cuda/bin): the SASS scan cannot "
                              "run on this card"])
    paths = _build.build(units)

    def dump(u):
        t0 = time.perf_counter()
        p = paths.get(u)
        if p is None or not os.path.exists(p):
            return u, None, f"{u}: library missing", 0.0
        r = subprocess.run([tool, "-sass", str(p)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            return (u, None, f"{u}: cuobjdump failed: {r.stderr[-300:]}",
                    0.0)
        return u, scan_sass(r.stdout), None, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(units)) as tp:
        dumps = list(tp.map(dump, units))
    by_unit, problems = {}, []
    for u, kernels, err, _ in dumps:
        if err:
            problems.append(err)
            continue
        if not kernels:
            problems.append(f"{u}: no kernel in the listing")
        by_unit[u] = {k["kernel"]: dict(f32=k["f32"],
                                         div_sites=k["div_sites"])
                      for k in kernels}
        problems += [f"{u}: {p}" for k in kernels for p in k["problems"]]
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    totals = {u: {op: sum(k["f32"][op] for k in ks.values())
                  for op in F32_OPS} for u, ks in by_unit.items()}
    return dict(entry="event_loop_units", passed=not problems, run=True,
                cuobjdump=version[-1] if version else tool,
                dump_s={u: round(t, 3) for u, _, _, t in dumps},
                f32_by_unit=totals, by_unit=by_unit, allowed=ALLOWED,
                problems=problems)

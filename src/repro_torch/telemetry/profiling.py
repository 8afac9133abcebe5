"""Profiling hooks: compile/run split, the phase breakdown of one port
call, and run-provenance metadata (counterpart of
`repro.telemetry.profiling`, on PyTorch).

The JAX package splits a jitted call into XLA's ahead-of-time stages;
the port has no tracing or lowering stage, so `call_breakdown` splits
one call into what it does spend time on: building or loading the
kernel libraries (``kernels/_build.py``), packing its operands on the
host, the launches up to a synchronize, and the copies back. The
engine wrappers and the runners mark those phases through `phase`,
which costs nothing outside a `call_breakdown` (no timer, no
synchronize)."""
from __future__ import annotations

import hashlib
import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch


def spec_hash(spec) -> str:
    """Stable short hash of an ExperimentSpec's semantic content."""
    try:
        payload = spec.meta
    except Exception:
        payload = {k: v for k, v in vars(spec).items()
                   if not k.startswith("_")}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def provenance(spec=None, *, device=None, **extra) -> Dict[str, object]:
    """Run-provenance dict for benchmark rows and result meta: the
    device's type, name and count, the torch and CUDA versions and, with
    a spec, its hash, lane chunk and whether it traces events."""
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    cuda = dev.type == "cuda"
    out: Dict[str, object] = dict(
        backend=dev.type,
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        n_devices=torch.cuda.device_count() if cuda else 1,
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
    )
    if spec is not None:
        out["spec_hash"] = spec_hash(spec)
        out["lane_chunk"] = getattr(spec, "lane_chunk", None)
        out["trace_events"] = bool(getattr(spec, "trace_events", False))
    out.update(extra)
    return out


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def compile_run_split(fn: Callable, *args, repeats: int = 3, **kwargs):
    """Wall-clock first-call vs steady-state split of a port call.

    The first call builds or loads what it needs (kernel libraries) and
    runs once; the best of ``repeats`` warm calls is the run. Each call
    ends in a synchronize when CUDA is in use. Returns ``(compile_s,
    run_s, result)``, ``compile_s`` the first call's wall time minus the
    warm one (floored at 0)."""
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    _sync()
    cold = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return max(cold - best, 0.0), best, res


class PhaseTimer:
    """Named wall-clock phase accumulator.

    >>> pt = PhaseTimer()
    >>> with pt.phase("lower"):
    ...     do_work()
    >>> pt.report()  # {'lower': 0.12}
    """

    def __init__(self):
        self.acc: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] = (self.acc.get(name, 0.0)
                              + time.perf_counter() - t0)

    def report(self, ndigits: Optional[int] = 6) -> Dict[str, float]:
        if ndigits is None:
            return dict(self.acc)
        return {k: round(v, ndigits) for k, v in self.acc.items()}


# the timer of the open `call_breakdown` (None outside one) and its open
# phases, innermost last: [name, time it last started or resumed]
_TIMER: Optional[PhaseTimer] = None
_OPEN: list = []
PHASES = ("build", "pack", "launch", "copy")


@contextmanager
def phase(name: str, device=None):
    """Mark one phase of a port call for `call_breakdown` (one of
    `PHASES`). Outside a breakdown it does nothing; inside, it adds the
    phase's wall time and, with a CUDA ``device``, ends the phase in a
    synchronize, so that a launch's time is launch-to-synchronize. A
    phase opened inside another pauses it (the eager loop's copies back
    inside its run), so that the phases never count a second twice."""
    timer = _TIMER
    if timer is None:
        yield
        return
    now = time.perf_counter()
    if _OPEN:
        outer = _OPEN[-1]
        timer.acc[outer[0]] = timer.acc.get(outer[0], 0.0) + now - outer[1]
    _OPEN.append([name, now])
    try:
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        now = time.perf_counter()
        _, t0 = _OPEN.pop()
        timer.acc[name] = timer.acc.get(name, 0.0) + now - t0
        if _OPEN:
            _OPEN[-1][1] = now


def call_breakdown(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Per-phase wall clock of one port call (for example
    ``run_experiment(spec)``): ``build_s`` (kernel libraries built or
    loaded, as `kernels._build` records them), ``pack_s`` (operands
    packed on the host and moved to the device), ``launch_s`` (each
    launch up to a synchronize; the eager loop's run on the CPU),
    ``copy_s`` (results and event records copied back), ``other_s`` (the
    rest) and ``total_s``; each second counts in one phase. ``built``
    holds the seconds of each kernel source that nvcc built during the
    call (`kernels._build.BUILD_INFO`). Nested breakdowns are not
    supported."""
    from repro_torch.kernels import _build
    global _TIMER
    if _TIMER is not None:
        raise RuntimeError("call_breakdown: already inside a breakdown")
    before = set(_build.BUILD_INFO)
    timer = PhaseTimer()
    _TIMER = timer
    try:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        total = time.perf_counter() - t0
    finally:
        _TIMER = None
        _OPEN.clear()
    out = {f"{p}_s": timer.acc.get(p, 0.0) for p in PHASES}
    out["other_s"] = max(total - sum(out.values()), 0.0)
    out["total_s"] = total
    out["built"] = {k: v["seconds"] for k, v in _build.BUILD_INFO.items()
                    if k not in before and v["seconds"] > 0}
    return out

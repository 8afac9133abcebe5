"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each ``csrc/<name>.cu`` exports a plain C interface and compiles on its
own into ``build/kernels/lib<name>-<digest>.so`` under the repository
root (listed in ``.gitignore``), at first use. The digest covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a stale library is never loaded. Building needs
``nvcc`` (on ``PATH`` or under ``$CUDA_HOME``/``/usr/local/cuda``);
there is no fallback when it is missing or fails: the caller gets the
compiler's error.

`build` starts one ``nvcc`` per source, all at once, and waits for all
of them, so the build time of several kernels is that of the slowest.

The helpers at the end are what every kernel wrapper shares: the
ctypes binding of an entry, the checks on its tensors, the launch's
error code, the device's SM count and the stream.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                "-v")
# per source, on top of COMMON_FLAGS: the f64 engine bodies (frp_select
# and the event loop, which inlines it) must be bitwise the reference,
# so no multiply-add is contracted there; the attention, norm and SSD
# kernels hold a tolerance
# the event-loop kernel's K-node units: each builds event_loop.cu's K-node
# form of two variants (csrc/event_loop_cluster_*.cu), beside the others
CLUSTER_UNITS = ("event_loop_cluster_esff", "event_loop_cluster_esff_lru",
                 "event_loop_cluster_queue", "event_loop_cluster_faas")
# the traced forms of the event-loop kernel (the trace rail a compile-time
# flag, K0_TRACED): the single-node form in one unit, the K-node form in
# four units as above, so that the untraced units compile as before
TRACED_UNITS = ("event_loop_traced",)
CLUSTER_TRACED_UNITS = tuple(u.replace("cluster", "cluster_traced")
                             for u in CLUSTER_UNITS)
EVENT_LOOP_UNITS = (("event_loop",) + CLUSTER_UNITS + TRACED_UNITS
                    + CLUSTER_TRACED_UNITS)
EXTRA_FLAGS = {"frp_select": ("--fmad=false",),
               **{u: ("--fmad=false",) for u in EVENT_LOOP_UNITS}}
SOURCES = (*EVENT_LOOP_UNITS, "frp_select", "rmsnorm", "decode_attention",
           "flash_attention", "ssd_chunk", "flash_attention_bwd",
           "rmsnorm_bwd", "ssd_chunk_bwd", "mla_decode")
# the sources another one includes (beside the shared headers)
INCLUDES = {u: ("event_loop.cu",) for u in EVENT_LOOP_UNITS[1:]}


def nvcc_flags(name: str) -> tuple:
    return COMMON_FLAGS + EXTRA_FLAGS.get(name, ())

_LIBS: Dict[str, ctypes.CDLL] = {}
# held while a library is built or loaded: a run over several devices
# calls the wrappers from a host thread a device
_LOAD_LOCK = threading.Lock()
# per source: seconds the build took (0.0 when an existing library was
# reused) and what ptxas reported (registers, shared memory, spills; for a
# reused library, its build's report, kept beside it as lib*.ptxas)
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    # the source, every shared header it may include, the sources it
    # includes, and the flags
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))) + b"".join(
        (CSRC / f).read_bytes() for f in INCLUDES.get(name, ()))
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` each, in parallel. Raises RuntimeError with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        if n not in todo:
            # a reused library: its build's ptxas report, kept beside it
            rep = paths[n].with_suffix(".ptxas")
            BUILD_INFO.setdefault(n, dict(
                seconds=0.0, ptxas=rep.read_text() if rep.exists() else ""))
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            continue
        paths[n].with_suffix(".ptxas").write_text(out)
        os.replace(tmp, paths[n])   # atomic: no half-written library
        BUILD_INFO[n] = dict(seconds=time.perf_counter() - t0, ptxas=out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build((name,))[name]))
                _LIBS[name] = lib
    return lib


# ----------------------------------------------- shared by the wrappers
PTR = ctypes.c_void_p
# the dtype codes of the attention and norm entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def c_entry(source: str, symbol: str, argtypes):
    """``symbol`` of ``csrc/<source>.cu`` (built on first use) with its
    argument types set; every entry returns a cudaError_t as int."""
    f = getattr(load_library(source), symbol)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check_tensor(name: str, x, dtypes, device, ndim: int = None) -> None:
    """Raise unless ``x`` is a contiguous tensor on ``device`` with a
    dtype in ``dtypes`` (and ``ndim`` dimensions, when given)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got "
                        f"{type(x).__name__}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype}, kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if ndim is not None and x.dim() != ndim:
        raise ValueError(f"{name}: {x.dim()} dimensions, expected {ndim}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, other inputs on "
                         f"{device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch_check(rc: int, symbol: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol}: launch failed with CUDA error {rc}")


def require_cuda(name: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: device {device} is neither cpu nor "
                         "cuda")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(device) -> int:
    """The handle of PyTorch's current stream on ``device`` (a
    torch.device or a CUDA index): the raw pointer, read as Triton's
    launcher reads it, without building a ``Stream`` object."""
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)

"""Fault-tolerant checkpointing (counterpart of
`repro.checkpoint.checkpointer`), in the JAX package's on-disk format, so
that a checkpoint written by either trainer restores in the other.

* **Format**: ``<dir>/step_N/manifest.json`` (``{"step": N, "leaves":
  {key: {"file", "shape", "dtype", "crc32"}}}``) and one
  ``leaf_NNNNN.npy`` a leaf, numbered in the sorted order of the keys. A
  key is the leaf's path in the tree joined by ``::`` (a dict's key, a
  list's index as ``#i``); a bf16 leaf is stored as its raw bytes
  (``uint8`` of shape (..., 2)) with dtype ``"bfloat16"`` (read back
  through a ``uint8`` tensor viewed as bf16: no ``ml_dtypes``).
* **Atomic**: a save writes ``tmp.step_N`` and renames it to ``step_N``
  after the manifest is fsynced; a crash mid-write leaves nothing that
  `latest_step` or a restore would read.
* **Async**: ``save(..., blocking=False)`` copies the tree to host memory
  at once (so the step loop may go on updating it in place) and writes
  on a background thread; ``wait()`` joins it, and raises what it
  raised.
* **Keep-N GC** after each save; **integrity**: a crc32 a leaf file,
  checked on restore (a bad step raises, and ``strict=False`` falls back
  to the previous one). Each file is one pass of the disk: a save writes
  the .npy header (the one np.save writes) and the array's own buffer,
  the crc taken over the same bytes, and a restore reads a file once,
  checks it and views the array in the same buffer; the leaves are
  written and read by IO_THREADS threads at a time (zlib's crc32 and the
  file calls release the GIL). A full-width Qwen3-4B's parameters and
  f32 moments are ~44 GB.

The trees are nested dicts (or lists) whose leaves are tensors or numpy
arrays. A trainer's tree is ``{"params": ..., "opt": {"mu", "nu",
"step"}}`` with the parameters nested by their dotted names
(`nest`), which are the JAX tree's paths: ``params::blocks::attn::wq``
in both packages. Restoring onto a mesh or with target shardings waits
for the sharding bullet (ROADMAP Queue 1, item 6 (sharding)).
"""
from __future__ import annotations

import io
import json
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
import re
import shutil
import threading
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

log = logging.getLogger("repro_torch.checkpoint")

_SEP = "::"
IO_THREADS = 8
_NUMPY_NATIVE = {"bool", "int8", "uint8", "int16", "uint16", "int32",
                 "uint32", "int64", "uint64", "float16", "float32",
                 "float64", "complex64", "complex128"}


def nest(flat: Dict[str, object]) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flatten(tree, prefix=()) -> Dict[str, object]:
    """The leaves of a nested dict / list tree by their ``::`` keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (f"#{i}",)))
        return out
    return {_SEP.join(prefix): tree}


def _host(leaf):
    """A leaf copied to host memory: a CPU tensor (bf16 kept) or a numpy
    array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _store(arr):
    """(the array np.save writes, the manifest's dtype) of a host leaf."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            raw = arr.contiguous().reshape(-1).view(torch.uint8)
            return raw.numpy().reshape(tuple(arr.shape) + (2,)), "bfloat16"
        arr = arr.numpy()
    return arr, str(arr.dtype)


def _write_npy(path: Path, arr) -> int:
    """``arr`` in np.save's format (the version 1.0 header, then the C
    order data) at ``path``; returns the file's crc32."""
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arr))
    data = memoryview(arr.reshape(-1).view(np.uint8))
    with open(path, "wb") as f:
        f.write(head.getvalue())
        f.write(data)
    return zlib.crc32(data, zlib.crc32(head.getvalue()))


def _read_checked(path: Path, crc: int, key: str, step: int):
    """A leaf file read once into a writable buffer; its crc checked; the
    array viewed in the buffer (np.save's format, C order)."""
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        f.readinto(buf)
    if zlib.crc32(buf) != crc:
        raise IOError(f"crc mismatch for {key} in step {step}")
    head = io.BytesIO(buf)
    version = np.lib.format.read_magic(head)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(head)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(head))
    if fortran or dtype.hasobject:
        raise ValueError(f"leaf {key!r}: unsupported array layout")
    return np.frombuffer(buf, dtype=dtype, count=math.prod(shape),
                         offset=head.tell()).reshape(shape)


def _load(arr, meta):
    """A leaf's array as a CPU tensor of its logical dtype."""
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.reshape(-1)).view(torch.bfloat16) \
            .reshape(meta["shape"])
    if meta["dtype"] not in _NUMPY_NATIVE:
        raise ValueError(f"unsupported checkpoint dtype {meta['dtype']!r}")
    return torch.from_numpy(arr)


def _unflatten_into(target, flat, prefix=()):
    """The checkpoint's leaves in the structure of ``target``; each as a
    tensor on the target leaf's device when that leaf is a tensor, on the
    CPU for a ``meta`` one (shapes only), the checkpoint's dtype kept."""
    if isinstance(target, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_into(v, flat, prefix + (f"#{i}",))
                            for i, v in enumerate(target))
    key = _SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if hasattr(target, "shape") and tuple(target.shape) != tuple(arr.shape):
        raise ValueError(f"leaf {key!r}: checkpoint shape "
                         f"{tuple(arr.shape)} != expected "
                         f"{tuple(target.shape)}")
    if isinstance(target, torch.Tensor) and target.device.type != "meta":
        arr = arr.to(target.device)
    return arr


def _steps(d: Path):
    return [int(m.group(1)) for p in d.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name))]


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = _steps(d)
    return max(steps) if steps else None


def save(directory, step: int, tree, keep: int = 3) -> None:
    Checkpointer(directory, keep=keep).save(step, tree, blocking=True)


def restore(directory, target, step: Optional[int] = None, mesh=None,
            shardings=None, strict: bool = True):
    return Checkpointer(directory).restore(target, step=step, mesh=mesh,
                                           shardings=shardings,
                                           strict=strict)


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True) -> None:
        self.wait()
        host = {k: _host(v) for k, v in flatten(tree).items()}
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()

    def _write_guarded(self, step, host):
        try:
            self._write(step, host)
        except BaseException as e:              # noqa: BLE001
            self._error = e

    def _write(self, step: int, host) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.dir / f"tmp.step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "leaves": {}}

        def put(item):
            i, (key, leaf) = item
            fname = f"leaf_{i:05d}.npy"
            arr, dtype = _store(leaf)
            return key, {"file": fname, "shape": list(leaf.shape),
                         "dtype": dtype, "crc32": _write_npy(tmp / fname,
                                                             arr)}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            manifest["leaves"].update(pool.map(
                put, enumerate(sorted(host.items()))))
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        log.info("saved checkpoint step %d (%d leaves)", step, len(host))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(_steps(self.dir))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore
    def restore(self, target, step: Optional[int] = None, mesh=None,
                shardings=None, strict: bool = True):
        """Load into the structure of ``target`` (a tree of tensors or
        arrays; tensors give the device). Returns (tree, step)."""
        if mesh is not None or shardings is not None:
            raise NotImplementedError(
                "restoring onto a mesh or target shardings is not ported "
                "(ROADMAP Queue 1, item 6 (sharding))")
        self.wait()
        candidates = ([step] if step is not None
                      else sorted(_steps(self.dir), reverse=True))
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                return _unflatten_into(target, self._read(s)), s
            except Exception as e:              # noqa: BLE001
                last_err = e
                log.warning("checkpoint step %s unusable: %s", s, e)
                if strict:
                    raise
        raise FileNotFoundError(
            f"no usable checkpoint in {self.dir}: {last_err}")

    def _read(self, step: int):
        d = self.dir / f"step_{step}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)

        def get(item):
            key, meta = item
            return key, _load(_read_checked(d / meta["file"], meta["crc32"],
                                            key, step), meta)
        with ThreadPoolExecutor(IO_THREADS) as pool:
            return dict(pool.map(get, manifest["leaves"].items()))

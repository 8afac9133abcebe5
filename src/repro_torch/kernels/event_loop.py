"""The ESFF event loop (K0): the CUDA kernel's wrapper and its plain
version.

Port of the lane-batched XLA ``while_loop`` of
`repro.core.jax_engine._simulate` with `repro.core.jax_policies`'
``ESFFKernel``. The kernel is ``csrc/event_loop.cu`` (see its header
for the design and the bound): one launch runs every lane of a chunk to
completion, one warp a lane, with the FRP scan (K1,
``csrc/frp_select.cuh``) inline. Its plain version is the eager loop,
`repro_torch.core.engine.simulate_eager`, and the kernel's results are
bitwise that loop's.

`event_loop` checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. CPU tensors go to the plain version
(counted in ``plain_calls``); CUDA tensors launch the kernel (counted in
``launches``) or raise. There is no fallback from a failed build or
launch to the plain version. `engine.simulate` routes a policy here by
its type (`has_device_loop`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import engine as E
from repro_torch.core.policies import ESFFKernel
from repro_torch.kernels import _build

# The kernel's layout: the bytes of one slot and of one function's
# state, and the columns of its (L, 9) counters and (L, 6) sums. The
# library reports its own (esff_event_loop_layout), and `_check_layout`
# holds it to these once before the first launch.
SLOT_BYTES = 40
FN_BYTES = 52
COUNTERS = ("next", "done", "iters", "stall", "seq", "gn", "cold",
            "evict", "ovf")
SUMS = ("g_sum", "cold_t", "evict_t", "r_sum", "s_sum", "r_max")
LAYOUT = (SLOT_BYTES, FN_BYTES, E.HIST_BINS, *range(len(COUNTERS)),
          len(COUNTERS), *range(len(SUMS)), len(SUMS))
# the dynamic shared memory one block can have on an H100 (227 KB)
SHARED_MAX = 232448
_I32_LIMIT = 2 ** 31 - 1

_P = _build.PTR
_I, _LL, _D = ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = [_P] * 10 + [_D] + [_I] * 7 + [_P, _LL, _LL] + [_P] * 7


def has_device_loop(kernel) -> bool:
    """Whether ``kernel`` has the event-loop kernel's hooks: the
    built-in ESFF policy (any name or default beta), not a subclass,
    which may override a hook."""
    return type(kernel) is ESFFKernel


def layout_plan(n_fns: int, n_slots: int) -> dict:
    """Where the kernel keeps a lane's state: the slots always in shared
    memory; the per-function state beside them when both fit in one
    block's shared memory, else in global scratch (``scratch_bytes`` a
    lane, 16-byte aligned)."""
    slots = SLOT_BYTES * n_slots
    fns = FN_BYTES * n_fns
    if slots + fns <= SHARED_MAX:
        return dict(fn_in_shared=True, smem_bytes=slots + fns,
                    scratch_bytes=0)
    return dict(fn_in_shared=False, smem_bytes=slots,
                scratch_bytes=-(-fns // 16) * 16)


def _check_layout() -> None:
    """Raise unless the built library's layout is `LAYOUT`."""
    if _check_layout.done:
        return
    f = _build.c_entry("event_loop", "esff_event_loop_layout", [_P, _I])
    got = (ctypes.c_longlong * len(LAYOUT))()
    n = f(got, len(LAYOUT))
    if n != len(LAYOUT) or tuple(got) != LAYOUT:
        raise RuntimeError(f"esff_event_loop: the library's layout "
                           f"{tuple(got)[:n]} is not the wrapper's {LAYOUT}")
    _check_layout.done = True


_check_layout.done = False


def _check(name, x, dtype, shape, device):
    name = f"event_loop: {name}"
    _build.check_tensor(name, x, (dtype,), device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{shape}")


def event_loop(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
               cap_mask, beta, prior, *, kernel, n_fns, capacity, queue_cap,
               stream=False):
    """Run the ESFF engine over L lanes to completion.

    ``fn_id`` (T, N) int64, ``arrival`` and ``exec_time`` (T, N) f64,
    ``t_cold`` and ``t_evict`` (T, F) f64, ``trace_ix`` (L,) int64,
    ``cap_mask`` (L, C) bool, ``beta`` (L,) f64, all contiguous on one
    device; ``prior`` a float. Returns `engine.simulate`'s dict. On a
    card, ``event_loop.last_scans`` is then the (L,) count of inline FRP
    scans of the launch (one per completion)."""
    if not has_device_loop(kernel):
        raise ValueError(f"event_loop: policy {kernel.name!r} "
                         f"({type(kernel).__name__}) has no device hooks")
    if fn_id.dim() != 2 or trace_ix.dim() != 1:
        raise ValueError(f"event_loop: fn_id must be (T, N) and trace_ix "
                         f"(L,), got {tuple(fn_id.shape)} and "
                         f"{tuple(trace_ix.shape)}")
    T, N = fn_id.shape
    L, F, C = trace_ix.shape[0], n_fns, capacity
    if min(T, N, L, F, C, queue_cap) < 1 or N > _I32_LIMIT:
        raise ValueError(f"event_loop: needs T, N, L, F, C, queue_cap >= 1 "
                         f"and N < 2^31, got T={T} N={N} L={L} F={F} C={C} "
                         f"queue_cap={queue_cap}")
    dev = fn_id.device
    f64, i64 = torch.float64, torch.int64
    for name, x, dt, shape in (
            ("fn_id", fn_id, i64, (T, N)), ("arrival", arrival, f64, (T, N)),
            ("exec_time", exec_time, f64, (T, N)),
            ("t_cold", t_cold, f64, (T, F)), ("t_evict", t_evict, f64, (T, F)),
            ("trace_ix", trace_ix, i64, (L,)),
            ("cap_mask", cap_mask, torch.bool, (L, C)),
            ("beta", beta, f64, (L,))):
        _check(name, x, dt, shape, dev)
    kw = dict(kernel=kernel, n_fns=F, capacity=C, queue_cap=queue_cap,
              stream=stream)
    if dev.type == "cpu":
        event_loop.plain_calls += 1
        return E.simulate_eager(fn_id, arrival, exec_time, t_cold, t_evict,
                                trace_ix, cap_mask, beta, prior, **kw)
    fn = _build.c_entry("event_loop", "esff_event_loop", _ARGTYPES)
    _build.require_cuda("event_loop", dev)
    _check_layout()
    pos_rids, pos_off = E.positional_layout(fn_id, F)
    plan = layout_plan(F, C)
    scratch = (None if plan["fn_in_shared"] else
               torch.empty((L, plan["scratch_bytes"]), dtype=torch.uint8,
                           device=dev))
    ctr = torch.empty((L, len(COUNTERS)), dtype=i64, device=dev)
    sums = torch.empty((L, len(SUMS)), dtype=f64, device=dev)
    hist = torch.empty((L, E.HIST_BINS), dtype=torch.int32, device=dev)
    scans = torch.empty((L,), dtype=i64, device=dev)
    start = comp = None
    if not stream:
        start = torch.full((L, N), -1.0, dtype=f64, device=dev)
        comp = torch.full((L, N), -1.0, dtype=f64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = fn(fn_id.data_ptr(), arrival.data_ptr(), exec_time.data_ptr(),
            pos_rids.data_ptr(), pos_off.data_ptr(), t_cold.data_ptr(),
            t_evict.data_ptr(), trace_ix.data_ptr(), cap_mask.data_ptr(),
            beta.data_ptr(), float(prior), L, N, F, C, queue_cap,
            int(plan["fn_in_shared"]), plan["smem_bytes"], ptr(scratch),
            plan["scratch_bytes"], E.max_events(N), ctr.data_ptr(),
            sums.data_ptr(), hist.data_ptr(), scans.data_ptr(), ptr(start),
            ptr(comp), _build.stream_of(dev))
    _build.launch_check(rc, "esff_event_loop")
    event_loop.launches += 1
    event_loop.last_scans = scans
    col = {k: i for i, k in enumerate(COUNTERS)}
    col.update({k: i for i, k in enumerate(SUMS)})
    i32 = torch.int32
    out = dict(cold_starts=ctr[:, col["cold"]].to(i32),
               cold_time=sums[:, col["cold_t"]],
               evictions=ctr[:, col["evict"]].to(i32),
               evict_time=sums[:, col["evict_t"]],
               overflow=ctr[:, col["ovf"]].to(i32),
               stalled=ctr[:, col["stall"]].to(i32),
               n_events=ctr[:, col["iters"]].to(i32),
               done=ctr[:, col["done"]].to(i32),
               resp_sum=sums[:, col["r_sum"]], slow_sum=sums[:, col["s_sum"]],
               max_response=sums[:, col["r_max"]], resp_hist=hist)
    if not stream:
        out["start"] = start
        out["completion"] = comp
    return out


event_loop.launches = 0
event_loop.plain_calls = 0
event_loop.last_scans = None

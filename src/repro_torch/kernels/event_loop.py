"""The scheduling event loop (K0): the CUDA kernel's wrapper and its
plain version.

Port of the lane-batched XLA ``while_loop`` of
`repro.core.jax_engine._simulate` with the policy kernels of
`repro.core.jax_policies`. The kernel is ``csrc/event_loop.cu`` (see its
header for the design and the bound): one launch runs every lane of a
chunk to completion, one warp a lane, in the variant of the lane
chunk's policy (`VARIANTS`): ESFF and ESFF-H with the FRP scan (K1,
``csrc/frp_select.cuh``) inline, the central queue (SFF, OpenWhisk),
FaasCache and OpenWhisk-v2 with its timer rail. Its plain version is the
eager loop, `repro_torch.core.engine.simulate_eager`, and the kernel's
results are bitwise that loop's.

`event_loop` checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. CPU tensors go to the plain version
(counted in ``plain_calls``); CUDA tensors launch the kernel (counted in
``launches``) or raise. There is no fallback from a failed build or
launch to the plain version. `engine.simulate` routes a policy here by
its type (`has_device_loop`). After a launch, ``last_scans`` (FRP
scans, ESFF variants), ``last_head_scans`` (central-queue head scans)
and ``last_timers`` (timer events, OpenWhisk-v2) hold its (L,) counts;
``variant_launches`` counts the launches of each variant and
``last_by_variant`` keeps each variant's last (L, 3) policy counts, so
that a run over several policies can be read back policy by policy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import engine as E
from repro_torch.core.policies import (CentralQueueKernel, ESFFKernel,
                                       FaasCacheKernel, OpenWhiskV2Kernel)
from repro_torch.kernels import _build

# The kernel's variants: the policy code of the C entry, the bytes of
# one slot and of one function's state. ESFF's two flags add the last
# dispatch time a slot (8 B: the LRU victim) and a COLD-slot count a
# function (4 B); the central queue's LRU needs the slot's last use,
# FaasCache a priority and a use count a slot (12 B), OpenWhisk-v2 the
# last use and a timer rail a function (32 B).
VARIANTS = {
    "esff": dict(code=0, slot_bytes=40, fn_bytes=52),
    "esff_cold": dict(code=1, slot_bytes=40, fn_bytes=56),
    "esff_lru": dict(code=2, slot_bytes=48, fn_bytes=52),
    "esff_h": dict(code=3, slot_bytes=48, fn_bytes=56),
    "fifo": dict(code=4, slot_bytes=48, fn_bytes=52),
    "sff": dict(code=5, slot_bytes=48, fn_bytes=52),
    "faascache": dict(code=6, slot_bytes=52, fn_bytes=52),
    "openwhisk_v2": dict(code=7, slot_bytes=48, fn_bytes=84),
}
# the columns of the kernel's (L, 9) counters, (L, 6) sums and (L, 3)
# policy counts
COUNTERS = ("next", "done", "iters", "stall", "seq", "gn", "cold",
            "evict", "ovf")
SUMS = ("g_sum", "cold_t", "evict_t", "r_sum", "s_sum", "r_max")
POLICY_COUNTS = ("frp_scans", "head_scans", "timers")
# the dynamic shared memory one block can have on an H100: 227 KB less
# room for the kernel's static shared memory (its lane tallies, 72 B;
# ptxas reports 80)
SHARED_MAX = 232448 - 128
_I32_LIMIT = 2 ** 31 - 1

_P = _build.PTR
_I, _LL, _D = ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = ([_I] + [_P] * 10 + [_D, _D] + [_I] * 7 + [_P, _LL, _LL]
             + [_P] * 6 + [_P, _P, _I, _D, _P, _P, _P, _P] + [_P])

# the built-in kernel classes, each with its variants (`variant_of`)
_BUILT_IN = (ESFFKernel, CentralQueueKernel, FaasCacheKernel,
             OpenWhiskV2Kernel)


def has_device_loop(kernel) -> bool:
    """Whether ``kernel`` has the event-loop kernel's hooks: an instance
    of one of the four built-in policy classes (any name, flags or
    default beta), not of a subclass, which may override a hook."""
    return type(kernel) in _BUILT_IN


def variant_of(kernel) -> str:
    """The kernel's variant (a key of `VARIANTS`) for a built-in policy;
    ValueError for any other."""
    if not has_device_loop(kernel):
        raise ValueError(f"event_loop: policy {kernel.name!r} "
                         f"({type(kernel).__name__}) has no device hooks")
    if type(kernel) is ESFFKernel:
        return {(False, False): "esff", (False, True): "esff_cold",
                (True, False): "esff_lru", (True, True): "esff_h"}[
            (bool(kernel.lru_victim), bool(kernel.cold_aware))]
    if type(kernel) is CentralQueueKernel:
        return kernel.order
    if type(kernel) is FaasCacheKernel:
        return "faascache"
    return "openwhisk_v2"


def layout(variant: str) -> tuple:
    """What the library reports for ``variant`` (event_loop_layout): its
    slot and function bytes, the histogram's bins, then the column of
    each counter, sum and policy count, each group followed by its
    width."""
    v = VARIANTS[variant]
    return (v["slot_bytes"], v["fn_bytes"], E.HIST_BINS,
            *range(len(COUNTERS)), len(COUNTERS), *range(len(SUMS)),
            len(SUMS), *range(len(POLICY_COUNTS)), len(POLICY_COUNTS))


def layout_plan(n_fns: int, n_slots: int, variant: str = "esff") -> dict:
    """Where the kernel keeps a lane's state in ``variant``: the slots
    always in shared memory (their bytes rounded up to 8); the
    per-function state beside them when both fit in one block's shared
    memory, else in global scratch (``scratch_bytes`` a lane, 16-byte
    aligned)."""
    v = VARIANTS[variant]
    slots = -(-v["slot_bytes"] * n_slots // 8) * 8
    fns = v["fn_bytes"] * n_fns
    if slots + fns <= SHARED_MAX:
        return dict(fn_in_shared=True, smem_bytes=slots + fns,
                    scratch_bytes=0)
    return dict(fn_in_shared=False, smem_bytes=slots,
                scratch_bytes=-(-fns // 16) * 16)


_CHECKED = set()


def _check_layout(variant: str) -> None:
    """Raise unless the built library's layout of ``variant`` is
    `layout` (checked once a variant)."""
    if variant in _CHECKED:
        return
    f = _build.c_entry("event_loop", "event_loop_layout", [_I, _P, _I])
    want = layout(variant)
    got = (ctypes.c_longlong * len(want))()
    n = f(VARIANTS[variant]["code"], got, len(want))
    if n != len(want) or tuple(got) != want:
        raise RuntimeError(f"event_loop: the library's layout of "
                           f"{variant} {tuple(got)[:max(n, 0)]} is not "
                           f"the wrapper's {want}")
    _CHECKED.add(variant)


def _check(name, x, dtype, shape, device):
    name = f"event_loop: {name}"
    _build.check_tensor(name, x, (dtype,), device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{shape}")


def event_loop(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
               cap_mask, beta, prior, *, kernel, n_fns, capacity, queue_cap,
               stream=False, threshold=0.1, n_live=None, deadlines=None,
               tl_bins=0, tl_bucket=60.0):
    """Run the engine over L lanes to completion under the built-in
    policy ``kernel``.

    ``fn_id`` (T, N) int64, ``arrival`` and ``exec_time`` (T, N) f64,
    ``t_cold`` and ``t_evict`` (T, F) f64, ``trace_ix`` (L,) int64,
    ``cap_mask`` (L, C) bool, ``beta`` (L,) f64, all contiguous on one
    device; ``prior`` and ``threshold`` floats. The engine options, each
    off by default: ``n_live`` (L,) int64 in [0, N], ``deadlines`` (F,)
    f64, ``tl_bins`` >= 0 bins of ``tl_bucket`` seconds. Returns
    `engine.simulate`'s dict. On a card, ``event_loop.last_scans``,
    ``last_head_scans`` and ``last_timers`` are then the launch's (L,)
    counts of inline FRP scans (one per completion in the ESFF
    variants), central-queue head scans and timer events."""
    variant = variant_of(kernel)
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
    if n_live is not None:
        _check("n_live", n_live, i64, (L,), dev)
        E.check_n_live(n_live, N)
    if deadlines is not None:
        _check("deadlines", deadlines, f64, (F,), dev)
    if tl_bins < 0 or tl_bins > _I32_LIMIT:
        raise ValueError(f"event_loop: tl_bins must be in [0, 2^31), got "
                         f"{tl_bins}")
    kw = dict(kernel=kernel, n_fns=F, capacity=C, queue_cap=queue_cap,
              stream=stream, threshold=threshold, n_live=n_live,
              deadlines=deadlines, tl_bins=tl_bins, tl_bucket=tl_bucket)
    if dev.type == "cpu":
        event_loop.plain_calls += 1
        return E.simulate_eager(fn_id, arrival, exec_time, t_cold, t_evict,
                                trace_ix, cap_mask, beta, prior, **kw)
    fn = _build.c_entry("event_loop", "event_loop_run", _ARGTYPES)
    _build.require_cuda("event_loop", dev)
    _check_layout(variant)
    pos_rids, pos_off = E.positional_layout(fn_id, F)
    plan = layout_plan(F, C, variant)
    scratch = (None if plan["fn_in_shared"] else
               torch.empty((L, plan["scratch_bytes"]), dtype=torch.uint8,
                           device=dev))
    ctr = torch.empty((L, len(COUNTERS)), dtype=i64, device=dev)
    sums = torch.empty((L, len(SUMS)), dtype=f64, device=dev)
    hist = torch.empty((L, E.HIST_BINS), dtype=torch.int32, device=dev)
    pcounts = torch.empty((L, len(POLICY_COUNTS)), dtype=i64, device=dev)
    start = comp = None
    if not stream:
        start = torch.full((L, N), -1.0, dtype=f64, device=dev)
        comp = torch.full((L, N), -1.0, dtype=f64, device=dev)
    i32 = torch.int32
    dl_miss = (None if deadlines is None else
               torch.zeros((L, F), dtype=i32, device=dev))
    tl = ((None,) * 3 if not tl_bins else
          (torch.zeros((L, tl_bins), dtype=i32, device=dev),
           torch.zeros((L, tl_bins), dtype=f64, device=dev),
           torch.zeros((L, tl_bins), dtype=f64, device=dev)))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = fn(VARIANTS[variant]["code"], fn_id.data_ptr(),
            arrival.data_ptr(), exec_time.data_ptr(), pos_rids.data_ptr(),
            pos_off.data_ptr(), t_cold.data_ptr(), t_evict.data_ptr(),
            trace_ix.data_ptr(), cap_mask.data_ptr(), beta.data_ptr(),
            float(prior), float(threshold), L, N, F, C, queue_cap,
            int(plan["fn_in_shared"]), plan["smem_bytes"], ptr(scratch),
            plan["scratch_bytes"], E.max_events(N), ctr.data_ptr(),
            sums.data_ptr(), hist.data_ptr(), pcounts.data_ptr(),
            ptr(start), ptr(comp), ptr(n_live), ptr(deadlines),
            int(tl_bins), float(tl_bucket), ptr(dl_miss), *map(ptr, tl),
            _build.stream_of(dev))
    _build.launch_check(rc, f"event_loop_run ({variant})")
    event_loop.launches += 1
    event_loop.variant_launches[variant] = (
        event_loop.variant_launches.get(variant, 0) + 1)
    event_loop.last_by_variant[variant] = pcounts
    event_loop.last_scans = pcounts[:, 0]
    event_loop.last_head_scans = pcounts[:, 1]
    event_loop.last_timers = pcounts[:, 2]
    col = {k: i for i, k in enumerate(COUNTERS)}
    col.update({k: i for i, k in enumerate(SUMS)})
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
    if tl_bins:
        out["tl_count"], out["tl_resp_sum"], out["tl_exec_sum"] = tl
    if deadlines is not None:
        out["deadline_miss"] = dl_miss
    if not stream:
        out["start"] = start
        out["completion"] = comp
    return out


event_loop.launches = 0
event_loop.plain_calls = 0
event_loop.variant_launches = {}
event_loop.last_by_variant = {}
event_loop.last_scans = None
event_loop.last_head_scans = None
event_loop.last_timers = None

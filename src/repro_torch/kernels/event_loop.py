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

`cluster_loop` is the K-node variant's wrapper (the dynamic cluster
tier, `repro_torch.cluster.engine`): the same variants over lanes that
each carry a cluster of K nodes behind a built-in dynamic router or a
circuit breaker around one (with node churn and delay schedules as lane
flags, and the resilience layer as a launch flag), with the eager K-node
loop `simulate_cluster_eager` as its plain version. It keeps its own
counts (``launches``, ``plain_calls``, ``variant_launches``,
``last_by_variant``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core import engine as E
from repro_torch.core.policies import (CentralQueueKernel, ESFFKernel,
                                       FaasCacheKernel, OpenWhiskV2Kernel)
from repro_torch.kernels import _build
from repro_torch.telemetry.rail import TR_RF, TR_RI

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
# the same for the K-node variant, whose static shared memory also holds
# the resilience layer's lane state (80 B)
CLUSTER_SHARED_MAX = 232448 - 256
_I32_LIMIT = 2 ** 31 - 1

_P = _build.PTR
_I, _LL, _D = ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = ([_I] + [_P] * 10 + [_D, _D] + [_I] * 7 + [_P, _LL, _LL]
             + [_P] * 6 + [_P, _P, _I, _D, _P, _P, _P, _P] + [_P])
# the K-node entry: the same, then topo, delays, kmax, slot_cap, links,
# node_done, node_of, churn_t, its columns, dtimes, dvals, dper, their
# steps, land_t, churn_counts; the resilience layer's flag, rs_nfail,
# rs_tmo, rs_key, att, rt_t, max_att, shed_mode, base, cap, jitter, the
# seed term, brk, resil_counts; before the stream
_CLUSTER_ARGTYPES = (_ARGTYPES[:-1] + [_P, _P, _I, _I, _P, _P, _P]
                     + [_P, _I, _P, _P, _P, _I, _P, _P]
                     + [_I, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _LL,
                        _P, _P] + [_P])
# the K-node variant's bytes a (node, function), by variant (its slots are
# the single-node variant's), a lane's t_cold and t_evict rows a
# function, a node (its breaker's window and reopen time among them), and
# JSQ's largest d on the card
CLUSTER_FN_BYTES = {"esff": 36, "esff_cold": 40, "esff_lru": 36,
                    "esff_h": 40, "fifo": 36, "sff": 36, "faascache": 36,
                    "openwhisk_v2": 84}
CLUSTER_LANE_FN_BYTES = 16
CLUSTER_NODE_BYTES = 88
CLUSTER_MAX_JSQ_D = 8
# the columns of the K-node variant's (L, 6) resilience counts, and the
# `simulate_cluster` output each one is
RESIL_COUNTS = ("failed", "timed_out", "retried", "shed",
                "failed_exhausted", "breaker_trips")

# the library (csrc/<source>.cu) that builds each variant's K-node form,
# two variants a unit, so that they build in parallel; and the traced
# forms' libraries (the trace rail is a compile-time flag, so the untraced
# forms are built as they were)
CLUSTER_SOURCE = {v: _build.CLUSTER_UNITS[c["code"] // 2]
                  for v, c in VARIANTS.items()}
TRACED_SOURCE = "event_loop_traced"
CLUSTER_TRACED_SOURCE = {v: _build.CLUSTER_TRACED_UNITS[c["code"] // 2]
                         for v, c in VARIANTS.items()}
# a traced launch's extra arguments: the (R, TR_RI) int32 and (R, TR_RF)
# f64 records and the (L + 1) int64 lane offsets (the K-node entry adds
# whether a record's node is -1, the single-node engine's), then stream
_TRACED_ARGTYPES = _ARGTYPES[:-1] + [_P, _P, _P] + [_P]
_CLUSTER_TRACED_ARGTYPES = _CLUSTER_ARGTYPES[:-1] + [_P, _P, _P, _I] + [_P]

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


def cluster_layout(variant: str) -> tuple:
    """What the library reports for ``variant``'s K-node form
    (event_loop_cluster_layout): its bytes a (node, function), a lane's
    function rows a function, a node, JSQ's largest d, a breaker's bit in
    the router code, and the column of each resilience count, then their
    width."""
    from repro_torch.cluster.routers import BREAKER_BIT
    return (CLUSTER_FN_BYTES[variant], CLUSTER_LANE_FN_BYTES,
            CLUSTER_NODE_BYTES, CLUSTER_MAX_JSQ_D, BREAKER_BIT,
            *range(len(RESIL_COUNTS)), len(RESIL_COUNTS))


def cluster_layout_plan(n_fns: int, slot_cap: int, kmax: int,
                        variant: str = "esff") -> dict:
    """Where the K-node variant keeps a lane's state: ``slot_cap`` slots
    (the largest K * C of a lane; bytes rounded up to 8) and the node
    table of ``kmax`` nodes in shared memory; the per-function state (the
    lane's rows, then K * F per-(node, function) entries, sized for
    ``kmax``) beside them when all fit in one block's shared memory, else
    in global scratch. Raises when the slots and nodes alone do not
    fit."""
    v = VARIANTS[variant]
    fixed = (-(-v["slot_bytes"] * slot_cap // 8) * 8
             + -(-CLUSTER_NODE_BYTES * kmax // 8) * 8)
    fns = (CLUSTER_LANE_FN_BYTES * n_fns
           + CLUSTER_FN_BYTES[variant] * kmax * n_fns)
    if fixed > CLUSTER_SHARED_MAX:
        raise ValueError(f"cluster_loop: {slot_cap} slots and {kmax} nodes "
                         f"need {fixed} B of shared memory, over "
                         f"{CLUSTER_SHARED_MAX}")
    if fixed + fns <= CLUSTER_SHARED_MAX:
        return dict(fn_in_shared=True, smem_bytes=fixed + fns,
                    scratch_bytes=0)
    return dict(fn_in_shared=False, smem_bytes=fixed,
                scratch_bytes=-(-fns // 16) * 16)


_CHECKED = set()   # the (variant, cluster, traced) forms already checked


def _check_layout(variant: str, cluster: bool = False,
                  traced: bool = False) -> None:
    """Raise unless the built library's layout of ``variant`` (its
    K-node form with ``cluster``, its traced form with ``traced``) is
    `layout` (`cluster_layout`), checked once a variant and form."""
    form = (variant, cluster, traced)
    if form in _CHECKED:
        return
    entry = "event_loop_cluster_layout" if cluster else "event_loop_layout"
    if cluster:
        source = (CLUSTER_TRACED_SOURCE if traced else CLUSTER_SOURCE)[
            variant]
    else:
        source = TRACED_SOURCE if traced else "event_loop"
    f = _build.c_entry(source, entry, [_I, _P, _I])
    want = cluster_layout(variant) if cluster else layout(variant)
    got = (ctypes.c_longlong * len(want))()
    n = f(VARIANTS[variant]["code"], got, len(want))
    if n != len(want) or tuple(got) != want:
        raise RuntimeError(f"event_loop: the library's {entry} of "
                           f"{variant} {tuple(got)[:max(n, 0)]} is not "
                           f"the wrapper's {want}")
    _CHECKED.add(form)


def trace_capacity(n_requests, delay=0, churn=0, retries=0, toggles=0):
    """Records a lane in a traced launch's first try: an arrival, a
    completion and a cold start a request; with ``delay`` (0 or 1) a
    landing a send; under ``churn`` (0 or 1) a re-route, its landing and
    its cold start a request, and ``toggles`` CHURN records; each of
    ``retries`` a RETRY record and its attempt's completion, cold start
    and landing. Ints, or (L,) int64 tensors for per-lane capacities.
    Timers (OpenWhisk-v2's) are not counted: a lane with more records
    costs one exact relaunch."""
    per_send = 3 + delay
    return (per_send * n_requests + (per_send - 1) * churn * n_requests
            + per_send * retries + toggles + 64)


class _TraceBuffers:
    """A traced launch's record buffers: lane l's records at rows
    [off[l], off[l + 1]) of (R, TR_RI) int32 and (R, TR_RF) f64 tensors,
    ``off`` from a per-lane capacity (an int) or exact counts (L,)."""

    def __init__(self, L, cap, dev):
        if isinstance(cap, int):
            self.off = torch.arange(L + 1, dtype=torch.int64,
                                    device=dev) * cap
            R = L * cap
        else:
            self.off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                              device=dev),
                                  torch.cumsum(cap.to(torch.int64), 0)])
            R = int(self.off[-1])
        self.tr_i = torch.empty((R, TR_RI), dtype=torch.int32, device=dev)
        self.tr_f = torch.empty((R, TR_RF), dtype=torch.float64, device=dev)

    def buffers(self) -> dict:
        """The device buffers by name (`repro_torch.analysis` reads
        them)."""
        return dict(tr_i=self.tr_i, tr_f=self.tr_f, tr_off=self.off)

    def args(self):
        return (self.tr_i.data_ptr(), self.tr_f.data_ptr(),
                self.off.data_ptr())

    def fits(self, counts) -> bool:
        return bool((counts <= self.off[1:] - self.off[:-1]).all())

    def flush(self, counts) -> None:
        """Hand each lane's first ``counts`` records to the active sink
        (one copy back of the used rows)."""
        from repro_torch.telemetry import profiling
        from repro_torch.telemetry.rail import active_sink
        sink = active_sink()
        if sink is None:
            return
        with profiling.phase("copy"):
            L = counts.shape[0]
            row = torch.arange(self.tr_i.shape[0], device=counts.device)
            lane = torch.searchsorted(self.off[1:L + 1], row, right=True)
            keep = row - self.off[lane.clamp(max=L - 1)] < counts[
                lane.clamp(max=L - 1)]
            off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
            sink.append_lanes(self.tr_i[keep].cpu().numpy(),
                              self.tr_f[keep].cpu().numpy(),
                              off.cpu().numpy())


def lane_trace_capacity(lanes, N, trace_ix, rs_nfail=None):
    """`trace_capacity` of each lane of a K-node call (`Topology`
    ``lanes``): its delay, churn and toggles, and under resilience the
    retries its trace's outcome plan (``rs_nfail`` (T, N)) makes."""
    retries = toggles = 0
    if lanes.resil is not None:
        retries = rs_nfail.to(torch.int64).clamp(
            max=int(lanes.resil[0]) - 1).sum(1)[trace_ix]
    if lanes.churn_t is not None:
        toggles = (lanes.churn_t < E.BIG).flatten(1).sum(1)
    return trace_capacity(N, lanes.lane_delay.to(torch.int64),
                          lanes.lane_churn.to(torch.int64), retries, toggles)


def _traced(launch, L, capacity, dev, entry) -> "_Results":
    """Run ``launch(buffers)`` (one traced launch) with ``capacity``
    records a lane (`trace_capacity`: an int, or (L,) per lane); when a
    lane had more events, launch again with each lane's exact count (the
    run is deterministic: the same stream). Hands the records to the
    active sink; ``entry.last_trace`` keeps the largest first capacity, the
    relaunches and the records."""
    from repro_torch.telemetry import profiling
    with profiling.phase("pack"):
        buf = _TraceBuffers(L, capacity, dev)
    res = launch(buf)
    counts = res.ctr[:, COUNTERS.index("iters")]
    relaunches = 0
    if not buf.fits(counts):
        with profiling.phase("pack"):
            buf = _TraceBuffers(L, counts, dev)
        res = launch(buf)
        counts = res.ctr[:, COUNTERS.index("iters")]
        relaunches = 1
        if not buf.fits(counts):
            raise RuntimeError(f"{entry.__name__}: the relaunch's events "
                               "differ from the first launch's")
    buf.flush(counts)
    entry.last_trace = dict(capacity=(capacity if isinstance(capacity, int)
                                      else int(capacity.max())),
                            relaunches=relaunches,
                            records=int(counts.sum()))
    return res


def _check(name, x, dtype, shape, device):
    name = f"event_loop: {name}"
    _build.check_tensor(name, x, (dtype,), device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{shape}")


def event_loop(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
               cap_mask, beta, prior, *, kernel, n_fns, capacity, queue_cap,
               stream=False, threshold=0.1, n_live=None, deadlines=None,
               tl_bins=0, tl_bucket=60.0, trace=False):
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
    variants), central-queue head scans and timer events.

    With ``trace`` the run also writes each lane's trace records
    (`repro_torch.telemetry.rail`) to the active sink: on a card through
    the kernel's traced form (``csrc/event_loop_traced.cu``; counted in
    ``traced_launches`` beside ``launches``), `trace_capacity` records
    a lane at first, launched again with exact counts when a lane had
    more (``last_trace``)."""
    from repro_torch.telemetry import profiling
    variant = variant_of(kernel)
    T, N, L, F, C = _check_inputs(
        fn_id, arrival, exec_time, t_cold, t_evict, trace_ix, cap_mask, beta,
        n_live, deadlines, tl_bins, n_fns, capacity, queue_cap)
    dev = fn_id.device
    kw = dict(kernel=kernel, n_fns=F, capacity=C, queue_cap=queue_cap,
              stream=stream, threshold=threshold, n_live=n_live,
              deadlines=deadlines, tl_bins=tl_bins, tl_bucket=tl_bucket)
    if dev.type == "cpu":
        _count_plain(event_loop, variant)
        with profiling.phase("launch"):
            return E.simulate_eager(fn_id, arrival, exec_time, t_cold,
                                    t_evict, trace_ix, cap_mask, beta,
                                    prior, trace=trace, **kw)
    with profiling.phase("build"):
        fn = (_build.c_entry(TRACED_SOURCE, "event_loop_traced_run",
                             _TRACED_ARGTYPES) if trace else
              _build.c_entry("event_loop", "event_loop_run", _ARGTYPES))
    _build.require_cuda("event_loop", dev)
    _check_layout(variant, traced=trace)
    with profiling.phase("pack"):
        pos_rids, pos_off = E.positional_layout(fn_id, F)
        plan = layout_plan(F, C, variant)

    def launch(buf):
        with profiling.phase("pack"):
            res = _Results(L, N, F, stream, deadlines, tl_bins, dev, plan)
            args = _shared_args(fn_id, arrival, exec_time,
                                pos_rids.data_ptr(), pos_off.data_ptr(),
                                t_cold, t_evict, trace_ix, cap_mask, beta,
                                prior, threshold, L, N, F, C, queue_cap,
                                plan, n_live, deadlines, tl_bins, tl_bucket,
                                res)
        with profiling.phase("launch", dev):
            rc = fn(VARIANTS[variant]["code"], *args,
                    *(buf.args() if buf is not None else ()),
                    _build.stream_of(dev))
            _build.launch_check(rc, f"event_loop_run ({variant}"
                                + (", traced)" if trace else ")"))
            _count(event_loop, variant, res.pcounts, trace)
        return res

    res = (_traced(launch, L, trace_capacity(N), dev, event_loop) if trace
           else launch(None))
    event_loop.last_scans = res.pcounts[:, 0]
    event_loop.last_head_scans = res.pcounts[:, 1]
    event_loop.last_timers = res.pcounts[:, 2]
    return res.outputs(stream, deadlines, tl_bins)


def _check_inputs(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
                  cap_mask, beta, n_live, deadlines, tl_bins, n_fns,
                  capacity, queue_cap, nodes=()):
    """The checks both entries share (``cap_mask`` is (L, *nodes, C));
    returns (T, N, L, F, C)."""
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
            ("cap_mask", cap_mask, torch.bool, (L, *nodes, C)),
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
    return T, N, L, F, C


class _Results:
    """The device buffers a launch allocates: its outputs (the counters,
    sums, histogram, policy counts; start / completion in exact mode; the
    options' folds) and the per-function scratch that ``plan``
    (`layout_plan`) puts in global memory. Every buffer the kernel writes
    is allocated here or, traced, in `_TraceBuffers`; the launch's other
    tensors are read-only operands derived from its inputs (the
    positional layout, the topology). So `buffers` is the state of a
    launch (`repro_torch.analysis` reads it at small shapes)."""

    def __init__(self, L, N, F, stream, deadlines, tl_bins, dev, plan):
        f64, i64, i32 = torch.float64, torch.int64, torch.int32
        self.scratch = (None if plan["fn_in_shared"] else
                        torch.empty((L, plan["scratch_bytes"]),
                                    dtype=torch.uint8, device=dev))
        self.ctr = torch.empty((L, len(COUNTERS)), dtype=i64, device=dev)
        self.sums = torch.empty((L, len(SUMS)), dtype=f64, device=dev)
        self.hist = torch.empty((L, E.HIST_BINS), dtype=i32, device=dev)
        self.pcounts = torch.empty((L, len(POLICY_COUNTS)), dtype=i64,
                                   device=dev)
        self.start = self.comp = None
        if not stream:
            self.start = torch.full((L, N), -1.0, dtype=f64, device=dev)
            self.comp = torch.full((L, N), -1.0, dtype=f64, device=dev)
        self.dl_miss = (None if deadlines is None else
                        torch.zeros((L, F), dtype=i32, device=dev))
        self.tl = ((None,) * 3 if not tl_bins else
                   (torch.zeros((L, tl_bins), dtype=i32, device=dev),
                    torch.zeros((L, tl_bins), dtype=f64, device=dev),
                    torch.zeros((L, tl_bins), dtype=f64, device=dev)))

    def buffers(self) -> dict:
        """The allocated device buffers by name."""
        named = dict(ctr=self.ctr, sums=self.sums, hist=self.hist,
                     pcounts=self.pcounts, start=self.start,
                     completion=self.comp, dl_miss=self.dl_miss,
                     tl_cnt=self.tl[0], tl_resp=self.tl[1],
                     tl_exec=self.tl[2], scratch=self.scratch)
        return {k: v for k, v in named.items() if v is not None}

    def outputs(self, stream, deadlines, tl_bins) -> dict:
        """`engine.simulate`'s dict of the launch's results."""
        return _outputs(self.ctr, self.sums, self.hist, self.start,
                        self.comp, stream, deadlines, tl_bins, self.tl,
                        self.dl_miss)


class _ClusterResults(_Results):
    """A K-node launch's device buffers: `_Results`', and the rid-chain
    links (``nxt``, ``tnx``, ``dnx`` as one (L, 3, N) tensor), each
    node's completions, the churn and resilience tallies, and the
    per-request rails a flag needs: ``node_of`` (exact mode with a
    delay), ``land_t`` (a delay), ``att`` and ``rt_t`` (resilience)."""

    def __init__(self, L, N, F, Kx, stream, deadlines, tl_bins, dev, plan,
                 any_delay, resil):
        super().__init__(L, N, F, stream, deadlines, tl_bins, dev, plan)
        f64, i64, i32 = torch.float64, torch.int64, torch.int32
        self.links = torch.full((L, 3, N), -1, dtype=i32, device=dev)
        self.node_done = torch.empty((L, Kx), dtype=i32, device=dev)
        self.churn_counts = torch.zeros((L, 2), dtype=i64, device=dev)
        self.resil_counts = torch.zeros((L, len(RESIL_COUNTS)), dtype=i64,
                                        device=dev)
        self.node_of = self.land_t = self.att = self.rt_t = None
        if not stream and any_delay:
            self.node_of = torch.zeros((L, N), dtype=i32, device=dev)
        if any_delay:
            self.land_t = torch.zeros((L, N), dtype=f64, device=dev)
        if resil is not None:
            self.att = torch.zeros((L, N), dtype=i32, device=dev)
            self.rt_t = torch.zeros((L, N), dtype=f64, device=dev)

    def buffers(self) -> dict:
        named = dict(super().buffers(), links=self.links,
                     node_done=self.node_done,
                     churn_counts=self.churn_counts,
                     resil_counts=self.resil_counts, node_of=self.node_of,
                     land_t=self.land_t, att=self.att, rt_t=self.rt_t)
        return {k: v for k, v in named.items() if v is not None}


def _ptr(x):
    return None if x is None else x.data_ptr()


def _shared_args(fn_id, arrival, exec_time, pos_rids, pos_off, t_cold,
                 t_evict, trace_ix, cap_mask, beta, prior, threshold, L, N,
                 F, C, queue_cap, plan, n_live, deadlines, tl_bins,
                 tl_bucket, res) -> tuple:
    """The arguments both C entries share, after the policy code."""
    scratch = res.scratch
    return (fn_id.data_ptr(), arrival.data_ptr(), exec_time.data_ptr(),
            pos_rids, pos_off, t_cold.data_ptr(), t_evict.data_ptr(),
            trace_ix.data_ptr(), cap_mask.data_ptr(), beta.data_ptr(),
            float(prior), float(threshold), L, N, F, C, queue_cap,
            int(plan["fn_in_shared"]), plan["smem_bytes"], _ptr(scratch),
            plan["scratch_bytes"], E.max_events(N), res.ctr.data_ptr(),
            res.sums.data_ptr(), res.hist.data_ptr(), res.pcounts.data_ptr(),
            _ptr(res.start), _ptr(res.comp), _ptr(n_live), _ptr(deadlines),
            int(tl_bins), float(tl_bucket), _ptr(res.dl_miss),
            *map(_ptr, res.tl))


# held while a launch is counted: a run over several devices launches
# from a host thread a device
_COUNT_LOCK = threading.Lock()


def _count_plain(entry, variant) -> None:
    """A call of ``entry``'s plain version (a CPU tensor): counted in
    ``plain_calls`` and, by variant, in ``plain_by_variant``."""
    with _COUNT_LOCK:
        entry.plain_calls += 1
        entry.plain_by_variant[variant] = (
            entry.plain_by_variant.get(variant, 0) + 1)


def _count(entry, variant, pcounts, traced=False) -> None:
    with _COUNT_LOCK:
        entry.launches += 1
        entry.variant_launches[variant] = (
            entry.variant_launches.get(variant, 0) + 1)
        entry.last_by_variant[variant] = pcounts
        if traced:
            entry.traced_launches[variant] = (
                entry.traced_launches.get(variant, 0) + 1)


def _outputs(ctr, sums, hist, start, comp, stream, deadlines, tl_bins, tl,
             dl_miss) -> dict:
    i32 = torch.int32
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
event_loop.plain_by_variant = {}
event_loop.variant_launches = {}
event_loop.traced_launches = {}
event_loop.last_by_variant = {}
event_loop.last_scans = None
event_loop.last_head_scans = None
event_loop.last_timers = None
event_loop.last_trace = None



def cluster_loop(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
                 cap_mask, beta, prior, *, kernel, routers, router_ix,
                 n_nodes, seeds, delays, n_fns, capacity, queue_cap,
                 stream=False, threshold=0.1, n_live=None, deadlines=None,
                 tl_bins=0, tl_bucket=60.0, churn_t=None, dtimes=None,
                 dvals=None, dper=None, rs_nfail=None, rs_tmo=None,
                 rs_key=None, resil=None, trace=False, trace_node=True):
    """Run the K-node engine over L lanes to completion under the
    built-in policy ``kernel`` and the dynamic routers ``routers``, each
    built-in (`repro_torch.cluster.routers.ROUTER_CODES`) or a
    `BreakerRouter` around one.

    Inputs as `event_loop`, but ``cap_mask`` is (L, K, C) bool, and each
    lane's topology: ``router_ix``, ``n_nodes`` and ``seeds`` (L,) int64
    (``n_nodes`` in [1, K]), ``delays`` (L, K) f64 >= 0, and, each None
    when no lane has it, ``churn_t`` (L, K, E) f64 and ``dtimes`` /
    ``dvals`` (L, K, D) f64 with ``dper`` (L, K); under resilience
    ``rs_nfail`` (T, N) int32, ``rs_tmo`` (T, N) bool, ``rs_key`` (T, N)
    int32 and the tuple ``resil`` (as `simulate_cluster`). Returns
    `cluster.engine.simulate_cluster`'s dict (``node_done`` (L, K);
    ``node_of`` (L, N) in exact mode when a lane has a delay; under churn
    ``toggles`` and ``reroutes`` (L,); under resilience its counts, with
    a breaker ``breaker_trips``). CPU tensors take the plain version
    `simulate_cluster_eager` (``cluster_loop.plain_calls``); CUDA tensors
    launch the K-node variant of the policy's kernel (``launches``,
    ``variant_launches``, ``last_by_variant``: each variant's last (L,
    3) policy counts) or raise. ``trace`` as `event_loop`'s, through the
    K-node form's traced units (``csrc/event_loop_cluster_traced_*.cu``),
    each record with its event's node (-1 without ``trace_node``)."""
    from repro_torch.telemetry import profiling
    from repro_torch.cluster.engine import (Topology, check_resil,
                                            check_topology,
                                            simulate_cluster_eager)
    from repro_torch.cluster.routers import BreakerRouter, router_code
    variant = variant_of(kernel)
    if cap_mask.dim() != 3:
        raise ValueError(f"cluster_loop: cap_mask must be (L, K, C), got "
                         f"{tuple(cap_mask.shape)}")
    L, Kx = cap_mask.shape[:2]
    T, N, L, F, C = _check_inputs(
        fn_id, arrival, exec_time, t_cold, t_evict, trace_ix, cap_mask, beta,
        n_live, deadlines, tl_bins, n_fns, capacity, queue_cap, (Kx,))
    dev = fn_id.device
    f64, i64, i32 = torch.float64, torch.int64, torch.int32
    for name, x, dt, shape in (
            ("router_ix", router_ix, i64, (L,)), ("n_nodes", n_nodes, i64, (L,)),
            ("seeds", seeds, i64, (L,)), ("delays", delays, f64, (L, Kx))):
        _check(name, x, dt, shape, dev)
    extra = {}
    if churn_t is not None:
        if churn_t.dim() != 3 or churn_t.shape[2] < 1:
            raise ValueError(f"cluster_loop: churn_t must be (L, K, E), got "
                             f"{tuple(churn_t.shape)}")
        extra["churn_t"] = (churn_t, (L, Kx, churn_t.shape[2]))
    if (dtimes is None) != (dvals is None) or (dtimes is None) != (
            dper is None):
        raise ValueError("cluster_loop: dtimes, dvals and dper go together")
    if dtimes is not None:
        if dtimes.dim() != 3 or dtimes.shape[2] < 1:
            raise ValueError(f"cluster_loop: dtimes must be (L, K, D), got "
                             f"{tuple(dtimes.shape)}")
        D = dtimes.shape[2]
        extra.update(dtimes=(dtimes, (L, Kx, D)), dvals=(dvals, (L, Kx, D)),
                     dper=(dper, (L, Kx)))
    for name, (x, shape) in extra.items():
        _check(name, x, f64, shape, dev)
    if any((x is None) != (resil is None) for x in (rs_nfail, rs_tmo,
                                                     rs_key)):
        raise ValueError("cluster_loop: resil and rs_nfail, rs_tmo, rs_key "
                         "go together")
    if resil is not None:
        check_resil(resil)
        for name, x, dt in (("rs_nfail", rs_nfail, i32),
                            ("rs_tmo", rs_tmo, torch.bool),
                            ("rs_key", rs_key, i32)):
            _check(name, x, dt, (T, N), dev)
        if kernel.has_timers:
            raise ValueError("cluster_loop: timer-rail kernels are not "
                             "supported under the resilience layer "
                             "(rejected at the runner)")
    check_topology(n_nodes, router_ix, delays, len(routers), dtimes, dper)
    lanes = Topology(routers, router_ix, n_nodes, seeds, delays, cap_mask,
                     churn_t, dtimes, dvals, dper, resil)
    if kernel.has_timers and lanes.any_churn:
        raise ValueError("cluster_loop: timer-rail kernels are not "
                         "supported under churn (rejected at the runner)")
    codes = [router_code(r) for r in routers]
    if any(d > CLUSTER_MAX_JSQ_D for c, d in codes if c % 4 == 0):
        raise ValueError(f"cluster_loop: JSQ's d must be <= "
                         f"{CLUSTER_MAX_JSQ_D} on the card, got "
                         f"{[d for _, d in codes]}")
    kw = dict(kernel=kernel, routers=routers, router_ix=router_ix,
              n_nodes=n_nodes, seeds=seeds, delays=delays, n_fns=F,
              capacity=C, queue_cap=queue_cap, stream=stream,
              threshold=threshold, n_live=n_live, deadlines=deadlines,
              tl_bins=tl_bins, tl_bucket=tl_bucket, churn_t=churn_t,
              dtimes=dtimes, dvals=dvals, dper=dper, rs_nfail=rs_nfail,
              rs_tmo=rs_tmo, rs_key=rs_key, resil=resil)
    if dev.type == "cpu":
        _count_plain(cluster_loop, variant)
        with profiling.phase("launch"):
            return simulate_cluster_eager(fn_id, arrival, exec_time, t_cold,
                                          t_evict, trace_ix, cap_mask, beta,
                                          prior, trace=trace,
                                          trace_node=trace_node, **kw)
    with profiling.phase("build"):
        fn = (_build.c_entry(CLUSTER_TRACED_SOURCE[variant],
                             "event_loop_cluster_traced_run",
                             _CLUSTER_TRACED_ARGTYPES) if trace else
              _build.c_entry(CLUSTER_SOURCE[variant],
                             "event_loop_cluster_run", _CLUSTER_ARGTYPES))
    _build.require_cuda("cluster_loop", dev)
    _check_layout(variant, cluster=True, traced=trace)
    with profiling.phase("pack"):
        # each lane's slots a node: its largest usable slot index + 1
        ar = torch.arange(1, C + 1, device=dev)
        lane_c = (cap_mask.any(1) * ar).amax(1).clamp_min(1)
        code_t = torch.tensor(codes, dtype=i64, device=dev)[router_ix]
        topo = torch.stack([n_nodes, lane_c, code_t[:, 0], code_t[:, 1],
                            seeds], 1).contiguous()
        slot_cap = int((n_nodes * lane_c).max())
        plan = cluster_layout_plan(F, slot_cap, Kx, variant)
        rk = (0, 0, 0.0, 0.0, 0.0, 0)
        if resil is not None:
            from repro_torch.core.resilience import JITTER_SALT
            max_att, mode, base, cap, jit, seed = resil
            rk = (int(max_att), int(mode), float(base), float(cap),
                  float(jit), (int(seed) ^ JITTER_SALT) & 0xFFFFFFFF)
        brk = None
        if lanes.any_brk:
            brk = torch.tensor([[r.volume, r.trip_at, r.cooldown]
                                if isinstance(r, BreakerRouter) else [0.0] * 3
                                for r in routers], dtype=f64,
                               device=dev)[router_ix].contiguous()

    def launch(buf):
        with profiling.phase("pack"):
            res = _ClusterResults(L, N, F, Kx, stream, deadlines, tl_bins,
                                  dev, plan, lanes.any_delay, resil)
            args = _shared_args(fn_id, arrival, exec_time, None, None,
                                t_cold, t_evict, trace_ix, cap_mask, beta,
                                prior, threshold, L, N, F, C, queue_cap,
                                plan, n_live, deadlines, tl_bins, tl_bucket,
                                res)
        with profiling.phase("launch", dev):
            rc = fn(VARIANTS[variant]["code"], *args,
                    topo.data_ptr(), delays.data_ptr(), Kx, slot_cap,
                    res.links.data_ptr(), res.node_done.data_ptr(),
                    _ptr(res.node_of), _ptr(churn_t),
                    0 if churn_t is None else churn_t.shape[2],
                    _ptr(dtimes), _ptr(dvals), _ptr(dper),
                    0 if dtimes is None else dtimes.shape[2],
                    _ptr(res.land_t), res.churn_counts.data_ptr(),
                    int(resil is not None), _ptr(rs_nfail), _ptr(rs_tmo),
                    _ptr(rs_key), _ptr(res.att), _ptr(res.rt_t), *rk,
                    _ptr(brk), res.resil_counts.data_ptr(),
                    *(buf.args() + (int(not trace_node),) if buf is not None
                      else ()),
                    _build.stream_of(dev))
            _build.launch_check(rc, f"event_loop_cluster_run ({variant}"
                                + (", traced)" if trace else ")"))
            _count(cluster_loop, variant, res.pcounts, trace)
        return res

    res = (_traced(launch, L, lane_trace_capacity(lanes, N, trace_ix,
                                                  rs_nfail), dev,
                   cluster_loop) if trace
           else launch(None))
    node_done, churn_counts = res.node_done, res.churn_counts
    resil_counts, node_of = res.resil_counts, res.node_of
    out = res.outputs(stream, deadlines, tl_bins)
    out["node_done"] = node_done
    if lanes.any_churn:
        out["toggles"] = churn_counts[:, 0]
        out["reroutes"] = churn_counts[:, 1]
    if resil is not None:
        for i, k in enumerate(RESIL_COUNTS[:-1]):
            out[k] = resil_counts[:, i].to(i32)
    if lanes.any_brk:
        out["breaker_trips"] = resil_counts[:, -1].to(i32)
    if node_of is not None:
        out["node_of"] = node_of
    return out


cluster_loop.launches = 0
cluster_loop.plain_calls = 0
cluster_loop.plain_by_variant = {}
cluster_loop.variant_launches = {}
cluster_loop.traced_launches = {}
cluster_loop.last_by_variant = {}
cluster_loop.last_trace = None

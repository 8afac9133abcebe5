"""Lower an `ExperimentSpec` onto the lane-batched engine.

Counterpart of the single-node branch of `repro.api.runner`: the grid
is flattened per policy, lanes ordered trace-major, then capacity, then
beta, split into lane chunks, and each chunk is one engine call on one
device. A capacity is a slot mask over max(capacities) slots, so every
capacity of the grid shares one call. Lanes are independent and the
engine is deterministic per lane, so results do not depend on the
chunking, the device a chunk runs on, or the host.

The scale-out is the JAX package's:

* **devices**: the lane chunks go round the CUDA devices (`local_devices`,
  capped by ``spec.devices``), each device with its own copy of the
  shared trace operands, each device's chunks in order on a host thread
  of its own; one device runs them in order on the caller's thread. The
  CPU is one device.
* **host sharding**: ``spec.host_shard=(i, n)`` keeps chunks ``i, i + n,
  ...`` of the chunk list; the `ResultSet` marks the other cells not
  computed (their metrics hold zeros) and `ResultSet.merge` joins the n
  hosts' parts into the full grid.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from repro_torch.api.registry import get_kernel
from repro_torch.api.results import ResultSet
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.engine import (goodput, lane_chunk_for,
                                     slo_attainment, sweep_metrics)
from repro_torch.telemetry import profiling, rail
from repro_torch.utils.device import resolve_device

_BETA_DEFAULT = "default"


def _unique_labels(labels):
    """Disambiguate repeated source labels positionally (``#k``
    suffix) so coordinate selection stays unambiguous."""
    seen: Dict[str, int] = {}
    out = []
    for lab in labels:
        k = seen.get(lab, 0)
        seen[lab] = k + 1
        out.append(lab if k == 0 else f"{lab}#{k}")
    return out


def _lower_grid(spec: ExperimentSpec):
    """Materialise sources and stack them into (T, ...) columns."""
    sources = spec.expanded_traces()
    arrs = [src.arrays() for src in sources]
    F = len(arrs[0]["cold_start"])
    N = len(arrs[0]["fn_id"])
    for src, a in zip(sources, arrs):
        if len(a["cold_start"]) != F or len(a["fn_id"]) != N:
            raise ValueError(
                f"ExperimentSpec traces must share shape "
                f"(n_functions, n_requests): {src.label} has "
                f"({len(a['cold_start'])}, {len(a['fn_id'])}), "
                f"{sources[0].label} has ({F}, {N})")
    stacked = {k: np.stack([np.asarray(a[k]) for a in arrs])
               for k in ("fn_id", "arrival", "exec_time", "cold_start",
                         "evict")}
    return sources, stacked, F, N


# the engines' trace operands: int64 function ids (they index), float64
# times (the JAX package lowers fn_id to int32; the port's engines take
# int64)
TRACE_DTYPES = dict(fn_id=torch.int64, arrival=torch.float64,
                    exec_time=torch.float64, cold_start=torch.float64,
                    evict=torch.float64)


def trace_operands(stacked: Dict[str, np.ndarray], dev) -> dict:
    """The (T, ...) trace columns of ``stacked`` as the engines' operands
    on ``dev``, in `TRACE_DTYPES`."""
    return {k: torch.as_tensor(stacked[k], dtype=dt, device=dev)
            for k, dt in TRACE_DTYPES.items()}


def lower_resilience(spec: ExperimentSpec, stacked: Dict[str, np.ndarray],
                     F: int):
    """``(stacked, rs)``: the trace columns with the attempts'
    (timeout-clipped) times in place of ``exec_time``, and
    `ExperimentSpec.resilience_ops`; ``(stacked, None)`` when the layer
    is off."""
    rs = spec.resilience_ops(stacked, F)
    if rs is None:
        return stacked, None
    return dict(stacked, exec_time=rs[0]), rs


def resil_kwargs(rs, dev) -> dict:
    """The engine keywords of the resilience operands ``rs`` on ``dev``
    (none when ``rs`` is None): the (T, N) outcome rows and the tuple."""
    if rs is None:
        return {}
    _, nfail, tmo, key, resil = rs
    return dict(rs_nfail=torch.tensor(nfail, device=dev),
                rs_tmo=torch.tensor(tmo, device=dev),
                rs_key=torch.tensor(key, device=dev), resil=resil)


def traced_call(call, traced: bool, n_lanes: int):
    """``call()``, and under ``traced`` inside its own `rail.collect`
    scope (traced calls run one after another); returns the call's
    result and each of its ``n_lanes`` lanes' event streams (None when
    not traced)."""
    if not traced:
        return call(), None
    with rail.collect() as sink:
        out = call()
    return out, [sink.lane_events(j) for j in range(n_lanes)]


def to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A call's result tensors copied back to the host."""
    with profiling.phase("copy"):
        return {k: v.cpu().numpy() for k, v in out.items()}


def _chunk_plan(spec: ExperimentSpec, T: int, chunk: int):
    """The chunk list [(policy_index, lane_lo, lane_hi)] (policy-major;
    lanes trace-major, then capacity, then beta)."""
    K = len(spec.capacities)
    B = 1 if spec.betas is None else len(spec.betas)
    plan = [(pi, lo, min(lo + chunk, T * K * B))
            for pi in range(len(spec.policies))
            for lo in range(0, T * K * B, chunk)]
    return plan, K, B


def local_devices(dev: torch.device, devices=None) -> List[torch.device]:
    """The devices a run's lane chunks go round: ``dev`` first, then the
    other CUDA devices in index order, the first ``devices`` of them
    (None: all). The CPU is one device. Raises when ``devices`` asks for
    more devices than there are."""
    devs = [dev]
    if dev.type == "cuda":
        first = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        devs += [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()) if i != first]
    if devices is not None:
        if devices > len(devs):
            raise ValueError(
                f"ExperimentSpec: devices={devices} but only {len(devs)} "
                "local device(s) present")
        devs = devs[:devices]
    return devs


def shard_chunks(spec: ExperimentSpec, plan: list, chunk: int) -> List[int]:
    """The indices of the chunks of ``plan`` that this host runs under
    ``spec.host_shard``; raises when it gets none."""
    host_i, host_n = spec.host_shard
    mine = [ci for ci in range(len(plan)) if ci % host_n == host_i]
    if not mine:
        raise ValueError(
            f"ExperimentSpec: host_shard={spec.host_shard} gets no "
            f"chunks (the grid lowers to {len(plan)} chunk(s) of "
            f"{chunk} lanes -- lower host count or lane_chunk)")
    return mine


def run_chunks(mine: List[int], devs: List[torch.device], run_chunk):
    """``{ci: run_chunk(ci, di)}`` for every chunk index of ``mine``, the
    j-th on device ``di = j % len(devs)``. One device: in order, on this
    thread. Several: each device's chunks in order on a host thread of
    its own, with that device current."""
    if len(devs) == 1:
        return {ci: run_chunk(ci, 0) for ci in mine}
    by_dev: Dict[int, List[int]] = {}
    for j, ci in enumerate(mine):
        by_dev.setdefault(j % len(devs), []).append(ci)

    def work(di):
        with torch.cuda.device(devs[di]):
            return {ci: run_chunk(ci, di) for ci in by_dev[di]}

    outs = {}
    with ThreadPoolExecutor(max_workers=len(devs)) as tp:
        for part in tp.map(work, sorted(by_dev)):
            outs.update(part)
    return outs


def result_meta(spec: ExperimentSpec, dev: torch.device, N: int, F: int,
                chunk: int, kernels: dict, n_devices: int = 1,
                **extra) -> dict:
    """The `ResultSet` meta of a run of ``spec`` on ``dev`` and
    ``n_devices`` devices (``extra`` appended: the cluster tier's
    ``cluster``)."""
    return dict(spec.meta,
                n_requests=N, n_functions=F, queue_cap=spec.queue_cap,
                stream=spec.stream, window=spec.window,
                tl_bins=spec.tl_bins, tl_bucket=spec.tl_bucket,
                prior=spec.prior, threshold=spec.threshold,
                lane_chunk=chunk, host_shard=list(spec.host_shard),
                n_devices=n_devices,
                deadlines=(None if spec.deadlines is None else
                           (spec.deadlines
                            if isinstance(spec.deadlines, float)
                            else list(spec.deadlines))),
                seeds=(list(spec.seeds) if spec.seeds is not None
                       else None),
                resilience=spec.resilience_meta(),
                trace_events=spec.trace_events,
                device=str(dev),
                device_name=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                default_betas={p: kernels[p].default_beta
                               for p in spec.policies},
                **extra)


def run_experiment(spec: ExperimentSpec, *, device=None) -> ResultSet:
    """Execute ``spec`` and return its labeled `ResultSet`.

    Runs on ``device`` (default ``spec.device``; CUDA unless it is
    ``"cpu"``) and raises when CUDA is wanted but absent. A spec with a
    ``cluster`` axis goes to
    `repro_torch.cluster.runner.run_cluster_experiment`, which stacks one
    grid a topology into the ResultSet's trailing ``cluster`` axis.

    ``spec.devices`` and ``spec.host_shard`` spread the lane chunks over
    the CUDA devices and over hosts (see the module docstring); a
    device asked for beyond those present, or a host shard that gets no
    chunk, raises.

    Under ``trace_events`` the lane chunks run one after another, each in
    its own `repro_torch.telemetry.collect` scope, and the ResultSet
    carries their event streams as a `repro_torch.telemetry.TraceRun`
    over its coordinates (``rs.trace``); its metrics are the untraced
    run's, bitwise."""
    spec.validate()
    dev = resolve_device(spec.device if device is None else device)
    if spec.cluster is not None:
        from repro_torch.cluster.runner import run_cluster_experiment
        return run_cluster_experiment(spec, dev)
    sources, stacked, F, N = _lower_grid(spec)
    dl = spec.deadline_ops(F)
    stacked, rs = lower_resilience(spec, stacked, F)
    T = len(sources)
    C = max(spec.capacities)
    masks = np.stack([np.arange(C) < c for c in spec.capacities])
    chunk = lane_chunk_for(spec.lane_chunk, dev)
    plan, K, B = _chunk_plan(spec, T, chunk)
    mine = shard_chunks(spec, plan, chunk)
    devs = local_devices(dev, spec.devices)
    if spec.trace_events:
        # traced chunks run one after another on one device, so that
        # the records of two chunks never meet in one collect scope
        devs = devs[:1]

    # the shared operands: one copy a device
    with profiling.phase("pack"):
        per_dev = [dict(
            shared=trace_operands(stacked, d),
            dl_op=None if dl is None else torch.as_tensor(dl, device=d),
            rs_kw=resil_kwargs(rs, d)) for d in devs]
    kernels = {p: get_kernel(p) for p in spec.policies}
    tix_col = np.repeat(np.arange(T, dtype=np.int64), K * B)
    mask_col = np.tile(np.repeat(masks, B, axis=0), (T, 1))

    def beta_col(policy: str) -> np.ndarray:
        bs = np.asarray(
            [kernels[policy].default_beta] if spec.betas is None
            else list(spec.betas), np.float64)
        return np.tile(bs, T * K)

    beta_cols = {p: beta_col(p) for p in spec.policies}

    def run_chunk(ci, di):
        pi, lo, hi = plan[ci]
        policy = spec.policies[pi]
        d, ops = devs[di], per_dev[di]
        sh = ops["shared"]
        return traced_call(lambda: to_numpy(sweep_metrics(
            sh["fn_id"], sh["arrival"], sh["exec_time"],
            sh["cold_start"], sh["evict"],
            torch.as_tensor(tix_col[lo:hi], device=d),
            torch.as_tensor(mask_col[lo:hi], device=d),
            torch.as_tensor(beta_cols[policy][lo:hi], device=d),
            spec.prior, spec.threshold, kernel=kernels[policy],
            n_fns=F, capacity=C, queue_cap=spec.queue_cap,
            stream=spec.stream, keep_responses=spec.keep_per_request,
            deadlines=ops["dl_op"], window=spec.window,
            tl_bins=spec.tl_bins, tl_bucket=spec.tl_bucket,
            trace=spec.trace_events, **ops["rs_kw"])),
            spec.trace_events, hi - lo)

    outs = run_chunks(mine, devs, run_chunk)
    P = len(spec.policies)
    flat: Dict[str, np.ndarray] = {}
    computed = np.zeros((P, T * K * B), bool)
    cells: Dict[tuple, dict] = {}
    for ci in mine:
        pi, lo, hi = plan[ci]
        out, events = outs[ci]
        for j, ev in enumerate(events or ()):
            t_i, rest = divmod(lo + j, K * B)
            cells[(pi, t_i) + divmod(rest, B)] = ev
        for k, v in out.items():
            if k not in flat:
                flat[k] = np.zeros((P, T * K * B) + v.shape[1:], v.dtype)
            flat[k][pi, lo:hi] = v
        computed[pi, lo:hi] = True

    data = {k: v.reshape((P, T, K, B) + v.shape[2:])
            for k, v in flat.items()}
    if dl is not None:
        data["slo_attainment"] = slo_attainment(data["deadline_miss"],
                                                data["done"])
    if rs is not None:
        data["goodput"] = goodput(data["done"], N)
    coords = dict(policy=list(spec.policies),
                  trace=_unique_labels([s.label for s in sources]),
                  capacity=list(spec.capacities),
                  beta=(list(spec.betas) if spec.betas is not None
                        else [_BETA_DEFAULT]))
    meta = result_meta(spec, dev, N, F, chunk, kernels, len(devs))
    return ResultSet(data=data, coords=coords,
                     computed=computed.reshape(P, T, K, B), meta=meta,
                     trace=trace_run(spec, coords, cells))


def trace_run(spec: ExperimentSpec, coords, cells):
    """The `TraceRun` of a traced run's ``cells`` over ``coords``, None
    when ``spec`` does not trace events."""
    if not spec.trace_events:
        return None
    from repro_torch.telemetry.spans import TraceRun
    return TraceRun(coords, cells)


# short alias -- `from repro_torch.api import run`
run = run_experiment

"""Declarative experiment surface: `TraceSource` + `ExperimentSpec`.

Counterpart of `repro.api.spec` for the ported single-node engine. A
trace source declares where a request stream comes from (a seeded
synthetic generator or inline columnar arrays) and materialises it to
the engine's columnar layout once (``arrays()``, cached); ``head(n)``
and ``scaled(ratio)`` (Fig. 6) wrap a source as the paper's figures
slice and re-intensify the shared trace. An
`ExperimentSpec` declares a whole study -- sources x policies x
capacities x betas plus the engine knobs -- as one validated value;
`repro_torch.api.run_experiment` lowers it onto the engine's lanes.

The spec keeps every field of the JAX package's spec, with its
validation, so the two are built the same way, plus the port's own
``device``. The scale-out fields are the JAX package's: ``devices`` caps
the CUDA devices a run spreads its lane chunks over, and
``host_shard=(i, n)`` keeps lane chunks ``i, i + n, ...``, so that n
hosts each run one part of a grid and `ResultSet.merge` joins the parts.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple, Union

import os

import numpy as np

from repro_torch.core.request import Trace

TRACE_COLUMNS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")

class TraceSource:
    """Declarative origin of one request stream.

    Subclasses implement ``_materialise() -> dict`` returning the
    engine's columnar layout (`TRACE_COLUMNS`) and a ``label``.
    ``arrays()`` caches the materialised columns for the source's
    lifetime."""

    label: str = "trace"

    def _materialise(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def arrays(self) -> Dict[str, np.ndarray]:
        """Columnar view (cached; arrays are marked read-only)."""
        cached = getattr(self, "_cache", None)
        if cached is None:
            cached = validate_trace_arrays(self._materialise(),
                                           where=self.label)
            for v in cached.values():
                v.setflags(write=False)
            object.__setattr__(self, "_cache", cached)
        return dict(cached)

    def to_trace(self) -> Trace:
        """Materialise `repro_torch.core.request.Trace` objects (the
        Python event engine's representation; avoid for large N)."""
        return Trace.from_arrays(self.arrays(), {"source": self.label})

    def head(self, n: int) -> "TraceSource":
        """First ``n`` requests (arrival order), same catalogue."""
        return HeadTrace(base=self, n=int(n))

    def scaled(self, ratio: float) -> "TraceSource":
        """Inter-arrival intensity scaling (paper Fig. 6): arrivals are
        multiplied by ``ratio`` (> 1 = lighter load), execution times
        untouched."""
        return ScaledTrace(base=self, ratio=float(ratio))

    def with_seed(self, seed: int) -> "TraceSource":
        """Re-seeded copy (generator-backed sources only)."""
        raise TypeError(
            f"trace source {self.label!r} ({type(self).__name__}) is "
            "not reseedable; ExperimentSpec(seeds=...) needs "
            "generator-backed sources (SyntheticTrace)")


def validate_trace_arrays(a: dict, where: str = "trace"
                          ) -> Dict[str, np.ndarray]:
    """Check/normalise a columnar trace dict (`TRACE_COLUMNS` layout)."""
    missing = [k for k in TRACE_COLUMNS if k not in a]
    if missing:
        raise ValueError(f"{where}: missing trace column(s) {missing}; "
                         f"need {list(TRACE_COLUMNS)}")
    out = dict(
        fn_id=np.ascontiguousarray(a["fn_id"], np.int32),
        arrival=np.ascontiguousarray(a["arrival"], np.float64),
        exec_time=np.ascontiguousarray(a["exec_time"], np.float64),
        cold_start=np.ascontiguousarray(a["cold_start"], np.float64),
        evict=np.ascontiguousarray(a["evict"], np.float64),
    )
    n = len(out["fn_id"])
    if not (len(out["arrival"]) == len(out["exec_time"]) == n):
        raise ValueError(f"{where}: request columns disagree on length")
    if len(out["cold_start"]) != len(out["evict"]):
        raise ValueError(f"{where}: function columns disagree on length")
    if n and out["fn_id"].max(initial=0) >= len(out["cold_start"]):
        raise ValueError(f"{where}: fn_id exceeds catalogue size "
                         f"{len(out['cold_start'])}")
    return out


@dataclass(frozen=True)
class SyntheticTrace(TraceSource):
    """Seeded Azure-like generator spec
    (`repro_torch.traces.synth_azure_arrays`)."""

    n_functions: int = 200
    n_requests: int = 30_000
    seed: int = 0
    params: Tuple[Tuple[str, float], ...] = ()

    @staticmethod
    def make(n_functions: int = 200, n_requests: int = 30_000,
             seed: int = 0, **params) -> "SyntheticTrace":
        """Keyword-friendly constructor (generator knobs as kwargs)."""
        return SyntheticTrace(n_functions=n_functions,
                              n_requests=n_requests, seed=seed,
                              params=tuple(sorted(params.items())))

    @property
    def label(self) -> str:
        return (f"synth[f{self.n_functions},n{self.n_requests},"
                f"seed{self.seed}]")

    def _materialise(self):
        from repro_torch.traces import synth_azure_arrays
        return synth_azure_arrays(n_functions=self.n_functions,
                                  n_requests=self.n_requests,
                                  seed=self.seed, **dict(self.params))

    def with_seed(self, seed: int) -> "SyntheticTrace":
        return replace(self, seed=int(seed))


@dataclass(frozen=True)
class NpzTrace(TraceSource):
    """A ``Trace.save_npz``-format file (the `TRACE_COLUMNS` arrays), e.g.
    the real Azure-2021 slice that ``scripts/prepare_azure_trace.py``
    produces."""

    path: str = ""

    @property
    def label(self) -> str:
        return f"npz[{os.path.basename(self.path) or self.path}]"

    def _materialise(self):
        if not self.path or not os.path.exists(self.path):
            raise FileNotFoundError(
                f"NpzTrace: no npz at {self.path!r} (see "
                "docs/azure_trace.md for producing one)")
        with np.load(self.path) as z:
            return {k: z[k] for k in TRACE_COLUMNS}


@dataclass(frozen=True)
class ArrayTrace(TraceSource):
    """Inline columnar arrays (already in the engine layout)."""

    arrays_in: Tuple[Tuple[str, np.ndarray], ...] = ()
    name: str = "arrays"

    @staticmethod
    def from_arrays(arrays: dict, name: str = "arrays") -> "ArrayTrace":
        """Wrap a columnar dict, e.g. what ``TraceSource.arrays()``
        returns in either package."""
        return ArrayTrace(arrays_in=tuple(sorted(arrays.items())),
                          name=name)

    @staticmethod
    def from_trace(trace: Trace, name: str = "") -> "ArrayTrace":
        """Wrap a `repro_torch.core.request.Trace` object."""
        return ArrayTrace.from_arrays(trace.to_arrays(),
                                      name or f"trace[n{len(trace)}]")

    @property
    def label(self) -> str:
        return self.name

    def _materialise(self):
        return dict(self.arrays_in)

    # ndarray is unhashable, so hash/eq fall back to identity
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class HeadTrace(TraceSource):
    """First-``n``-requests view of another source."""

    base: TraceSource = None
    n: int = 0

    @property
    def label(self) -> str:
        return f"head{self.n}({self.base.label})"

    def _materialise(self):
        a = self.base.arrays()
        out = {k: a[k][: self.n] for k in ("fn_id", "arrival",
                                           "exec_time")}
        out["cold_start"] = a["cold_start"]
        out["evict"] = a["evict"]
        return out

    def with_seed(self, seed: int) -> "HeadTrace":
        return replace(self, base=self.base.with_seed(seed))


@dataclass(frozen=True)
class ScaledTrace(TraceSource):
    """Intensity-scaled view (arrivals x ``ratio``) of another source."""

    base: TraceSource = None
    ratio: float = 1.0

    @property
    def label(self) -> str:
        return f"scale{self.ratio:g}({self.base.label})"

    def _materialise(self):
        a = self.base.arrays()
        out = dict(a)
        out["arrival"] = a["arrival"] * self.ratio
        return out

    def with_seed(self, seed: int) -> "ScaledTrace":
        return replace(self, base=self.base.with_seed(seed))


def as_trace_source(obj, name: str = "") -> TraceSource:
    """Coerce a source, a `Trace`, a columnar array dict or an npz path
    into a `TraceSource`."""
    if isinstance(obj, TraceSource):
        return obj
    if isinstance(obj, Trace):
        return ArrayTrace.from_trace(obj, name)
    if isinstance(obj, dict):
        return ArrayTrace.from_arrays(obj, name or "arrays")
    if isinstance(obj, (str, os.PathLike)):
        return NpzTrace(path=os.fspath(obj))
    raise TypeError(
        f"cannot interpret {type(obj).__name__!r} as a trace source; "
        "pass a TraceSource, Trace, columnar array dict, or npz path")


@dataclass
class ExperimentSpec:
    """One declared experiment: the grid ``traces x policies x
    capacities x betas`` plus engine options. ``seeds`` expands each reseedable
    source into one trace per seed. ``tl_bins > 0`` adds the Fig. 8
    timeline (``tl_bucket`` seconds a bin); ``deadlines`` (one scalar,
    or one value per function) adds the per-function ``deadline_miss``
    counts and the derived ``slo_attainment``; ``window`` changes no
    result; ``cluster`` adds a trailing axis of
    `repro_torch.cluster.ClusterSpec` topologies (``None`` entries are
    the plain single-node run). ``device`` is where the run goes: CUDA
    unless it is ``"cpu"``. ``devices`` caps the CUDA devices that the
    lane chunks go round over (None: every device; the CPU is one
    device), and ``host_shard=(i, n)`` runs only lane chunks ``i, i + n,
    ...``: the `ResultSet` marks the others not computed, and
    `ResultSet.merge` joins the n hosts' parts.

    Resilience: ``fail_prob`` (a scalar or one value a function) fails
    requests by a counter hash of ``fail_seed``, ``timeouts`` (seconds, a
    scalar or one a function) kills attempts that run longer, ``retry``
    (a `RetryPolicy`, ``RetryPolicy()`` when faults are on and it is
    None) re-enters a failed attempt after capped exponential backoff,
    and ``on_overflow`` is what a full queue does: ``"error"`` (drop and
    count ``overflow``; `ResultSet.check` fails), ``"shed"`` (drop the
    arriving request, counted in ``shed``) or ``"shed_oldest"`` (drop the
    queue's head). With every knob at its default the layer is off and a
    run is bitwise the run without it."""

    traces: Sequence = ()
    policies: Sequence[str] = ("esff",)
    capacities: Sequence[int] = (8, 16, 32)
    betas: Optional[Sequence[float]] = None
    seeds: Optional[Sequence[int]] = None
    queue_cap: int = 2048
    prior: float = 0.1
    threshold: float = 0.1
    stream: bool = True
    window: int = 0
    tl_bins: int = 0
    tl_bucket: float = 60.0
    keep_per_request: bool = False
    deadlines: Union[float, Sequence[float], None] = None
    fail_prob: Union[float, Sequence[float]] = 0.0
    timeouts: Union[float, Sequence[float], None] = None
    retry: Optional[object] = None
    on_overflow: str = "error"
    fail_seed: int = 0
    lane_chunk: Optional[int] = None
    devices: Optional[int] = None
    host_shard: Tuple[int, int] = (0, 1)
    cluster: Optional[Sequence] = None
    trace_events: bool = False
    meta: dict = field(default_factory=dict)
    device: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.traces, (TraceSource, dict, Trace, str)):
            self.traces = [self.traces]
        self.traces = tuple(as_trace_source(t) for t in self.traces)
        self.policies = tuple(self.policies)
        self.capacities = tuple(int(c) for c in self.capacities)
        if self.betas is not None:
            self.betas = tuple(float(b) for b in self.betas)
        if self.seeds is not None:
            self.seeds = tuple(int(s) for s in self.seeds)
        self.host_shard = tuple(int(x) for x in self.host_shard)
        if self.deadlines is not None:
            if np.isscalar(self.deadlines):
                self.deadlines = float(self.deadlines)
            else:
                self.deadlines = tuple(float(d) for d in self.deadlines)
        if self.cluster is not None:
            from repro_torch.cluster.spec import ClusterSpec
            if isinstance(self.cluster, ClusterSpec):
                self.cluster = (self.cluster,)
            self.cluster = tuple(self.cluster)
        if not np.isscalar(self.fail_prob):
            self.fail_prob = tuple(float(p) for p in self.fail_prob)
        if self.timeouts is not None and not np.isscalar(self.timeouts):
            self.timeouts = tuple(float(b) for b in self.timeouts)
        self.fail_seed = int(self.fail_seed)

    def validate(self) -> "ExperimentSpec":
        """Raise on the first invalid field; returns self."""
        from repro_torch.api.registry import get_kernel
        if self.trace_events:
            # a traced run keeps every lane on one device
            if self.host_shard != (0, 1):
                raise ValueError(
                    "ExperimentSpec: trace_events needs every lane "
                    "on this host; host_shard must stay (0, 1)")
            if self.devices not in (None, 1):
                raise ValueError(
                    "ExperimentSpec: traced runs execute serially on "
                    "the default device; devices must be None or 1, "
                    f"got {self.devices}")
        i, n = self.host_shard
        if n < 1 or not (0 <= i < n):
            raise ValueError(
                f"ExperimentSpec: host_shard must be (i, n) with "
                f"0 <= i < n, got {self.host_shard}")
        if self.devices is not None and self.devices < 1:
            raise ValueError("ExperimentSpec: devices must be >= 1 "
                             "(None = all local devices)")
        if not self.traces:
            raise ValueError("ExperimentSpec: no trace sources")
        if not self.policies:
            raise ValueError("ExperimentSpec: no policies")
        for p in self.policies:
            get_kernel(p)
        if len(set(self.policies)) != len(self.policies):
            raise ValueError(
                f"ExperimentSpec: duplicate policies {self.policies}")
        if not self.capacities:
            raise ValueError("ExperimentSpec: no capacities")
        if any(c <= 0 for c in self.capacities):
            raise ValueError(
                f"ExperimentSpec: capacities must be positive, got "
                f"{self.capacities}")
        if self.betas is not None and not self.betas:
            raise ValueError("ExperimentSpec: betas=() -- use None for "
                             "per-policy defaults")
        if self.seeds is not None:
            if not self.seeds:
                raise ValueError("ExperimentSpec: seeds=() -- use None "
                                 "to keep sources as declared")
            for t in self.traces:
                t.with_seed(self.seeds[0])   # raises on non-reseedable
        if self.queue_cap <= 0:
            raise ValueError("ExperimentSpec: queue_cap must be > 0")
        if self.window < 0 or self.tl_bins < 0:
            raise ValueError("ExperimentSpec: window/tl_bins must be "
                             ">= 0")
        if self.keep_per_request and self.stream:
            raise ValueError(
                "ExperimentSpec: keep_per_request needs stream=False "
                "(streaming folds per-request records away)")
        if self.deadlines is not None:
            vals = ([self.deadlines] if isinstance(self.deadlines, float)
                    else list(self.deadlines))
            if not vals:
                raise ValueError(
                    "ExperimentSpec: deadlines=() -- use None to disable "
                    "SLO accounting")
            for d in vals:
                if not np.isfinite(d) or d <= 0:
                    raise ValueError(
                        f"ExperimentSpec: deadlines must be finite and "
                        f"> 0, got {d}")
        from repro_torch.core.resilience import SHED_MODES, RetryPolicy
        if self.on_overflow not in SHED_MODES:
            raise ValueError(
                f"ExperimentSpec: on_overflow must be one of "
                f"{sorted(SHED_MODES)}, got {self.on_overflow!r}")
        fp = np.atleast_1d(np.asarray(self.fail_prob, np.float64))
        if np.any((fp < 0) | (fp > 1)) or not np.all(np.isfinite(fp)):
            raise ValueError(
                f"ExperimentSpec: fail_prob must be in [0, 1], got "
                f"{self.fail_prob}")
        if self.timeouts is not None:
            to = np.atleast_1d(np.asarray(self.timeouts, np.float64))
            if np.any(to <= 0) or not np.all(np.isfinite(to)):
                raise ValueError(
                    "ExperimentSpec: timeouts must be finite and > 0, "
                    f"got {self.timeouts}")
        if self.retry is not None and not isinstance(self.retry,
                                                     RetryPolicy):
            raise TypeError(
                "ExperimentSpec: retry must be a RetryPolicy or None, "
                f"got {type(self.retry).__name__}")
        if self.resilience_active():
            timered = [p for p in self.policies
                       if get_kernel(p).has_timers]
            if timered:
                raise ValueError(
                    f"ExperimentSpec: policies {timered} arm per-request "
                    "timers, which the resilience layer does not support "
                    "(a killed or retried request would leave a timer "
                    "aimed at a stale attempt); drop the policy or the "
                    "fail_prob/timeouts/on_overflow settings")
        elif self.retry is not None:
            raise ValueError(
                "ExperimentSpec: retry= without fail_prob/timeouts/"
                "on_overflow does nothing -- remove it or switch a fault "
                "knob on")
        if self.cluster is not None:
            from repro_torch.cluster.spec import ClusterSpec
            if not self.cluster:
                raise ValueError(
                    "ExperimentSpec: cluster=() -- use None for plain "
                    "single-node runs")
            for entry in self.cluster:
                if entry is None:
                    continue
                if not isinstance(entry, ClusterSpec):
                    raise TypeError(
                        f"ExperimentSpec: cluster entries must be "
                        f"ClusterSpec or None, got "
                        f"{type(entry).__name__}")
                entry.validate()
                if (entry.node_capacity is not None
                        and len(self.capacities) != 1):
                    raise ValueError(
                        "ExperimentSpec: a ClusterSpec with "
                        "node_capacity fixes per-node slots, so the "
                        "capacity axis must have exactly one entry (the "
                        f"aggregate label); got {self.capacities}")
            if self.host_shard != (0, 1):
                raise ValueError(
                    "ExperimentSpec: cluster runs do not support "
                    "host_shard yet")
            if self.devices not in (None, 1):
                raise ValueError(
                    "ExperimentSpec: cluster runs execute on the "
                    "default device; devices must be None or 1, got "
                    f"{self.devices}")
        return self

    def deadline_ops(self, n_fns: int) -> Optional[np.ndarray]:
        """Lower ``deadlines`` to the engine's (F,) float64 operand (a
        scalar broadcasts to every function), or ``None`` when SLO
        accounting is off. Raises if a per-function sequence does not
        match the catalogue size."""
        if self.deadlines is None:
            return None
        if isinstance(self.deadlines, float):
            return np.full((n_fns,), self.deadlines, np.float64)
        if len(self.deadlines) != n_fns:
            raise ValueError(
                f"ExperimentSpec: deadlines has {len(self.deadlines)} "
                f"entries but the trace catalogue declares {n_fns} "
                "functions (pass one scalar or one deadline per "
                "function)")
        return np.asarray(self.deadlines, np.float64)

    # ------------------------------------------------------- resilience
    def resilience_active(self) -> bool:
        """Whether a fault knob leaves its default: the engines then run
        the resilience layer; otherwise a run is bitwise the run without
        it."""
        fp = np.atleast_1d(np.asarray(self.fail_prob, np.float64))
        return (bool(np.any(fp > 0)) or self.timeouts is not None
                or self.on_overflow != "error")

    def retry_policy(self):
        """The `RetryPolicy` in force (the default one when faults are on
        and ``retry`` is None), or None when the layer is off."""
        from repro_torch.core.resilience import RetryPolicy
        if not self.resilience_active():
            return None
        return self.retry if self.retry is not None else RetryPolicy()

    def resilience_ops(self, stacked: Dict[str, np.ndarray], n_fns: int):
        """The fault knobs lowered to the engines' operands, or None when
        the layer is off: ``(eff_exec, n_fail, is_tmo, rid_key, resil)``,
        the (T, N) attempt times (``min(exec, timeout)``, in place of the
        exec operand), leading-failure counts, timeout flags and original
        request ids (the jitter's hash key; `plan_outcomes`), and the
        tuple ``resil`` = (max_attempts, shed mode, base, cap, jitter,
        fail_seed)."""
        from repro_torch.core.resilience import SHED_MODES, plan_outcomes
        rp = self.retry_policy()
        if rp is None:
            return None
        fn_id = np.asarray(stacked["fn_id"])
        ex = np.asarray(stacked["exec_time"])
        T, N = fn_id.shape
        eff = np.empty((T, N), np.float64)
        nfail = np.empty((T, N), np.int32)
        tmo = np.empty((T, N), bool)
        for t in range(T):
            eff[t], nfail[t], tmo[t] = plan_outcomes(
                fn_id[t], ex[t], fail_prob=self.fail_prob,
                timeouts=self.timeouts, max_attempts=rp.max_attempts,
                n_fns=n_fns, seed=self.fail_seed)
        key = np.broadcast_to(np.arange(N, dtype=np.int32), (T, N))
        resil = (int(rp.max_attempts), SHED_MODES[self.on_overflow],
                 float(rp.base), float(rp.cap), float(rp.jitter),
                 self.fail_seed)
        return eff, nfail, tmo, np.ascontiguousarray(key), resil

    def resilience_meta(self):
        """The fault knobs as JSON-friendly values for `ResultSet.meta`
        (None when the layer is off)."""
        rp = self.retry_policy()
        if rp is None:
            return None
        tolist = lambda v: (list(v) if isinstance(v, tuple)  # noqa: E731
                            else v)
        return dict(fail_prob=tolist(self.fail_prob),
                    timeouts=tolist(self.timeouts),
                    on_overflow=self.on_overflow, retry=list(rp.as_tuple()),
                    fail_seed=self.fail_seed)

    def expanded_traces(self) -> Tuple[TraceSource, ...]:
        """The trace axis after seed expansion (seed-major per source)."""
        if self.seeds is None:
            return self.traces
        return tuple(src.with_seed(s)
                     for src in self.traces for s in self.seeds)

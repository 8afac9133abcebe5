"""repro_torch.telemetry -- event tracing, streaming metrics and
profiling hooks (counterpart of `repro.telemetry`).

Layers (all opt-in; with tracing off the engines run as before, bitwise):

- :mod:`repro_torch.telemetry.rail` -- the trace rail: record layout,
  host sink, ``collect()`` scope.
- :mod:`repro_torch.telemetry.spans` -- per-request span reassembly and
  the per-cell :class:`TraceRun` container attached to ``ResultSet``.
- :mod:`repro_torch.telemetry.perfetto` -- Chrome/Perfetto
  ``trace_event`` JSON export and schema validation.
- :mod:`repro_torch.telemetry.metrics` -- per-bin per-node time series
  (queue depth, warm occupancy, utilization, SLO attainment, goodput)
  with CSV and Prometheus exporters.
- :mod:`repro_torch.telemetry.profiling` -- first-call/run split, the
  phase breakdown of one port call, run-provenance metadata.
"""
from repro_torch.telemetry.rail import (TraceKind, TraceSink, collect,
                                        merge_events)
from repro_torch.telemetry.spans import Span, TraceRun, assemble_spans
from repro_torch.telemetry.perfetto import (events_to_trace, save_trace,
                                            validate_trace)
from repro_torch.telemetry.metrics import (events_summary, timeline,
                                           timeline_to_csv, to_prometheus)
from repro_torch.telemetry.profiling import (PhaseTimer, call_breakdown,
                                             compile_run_split,
                                             provenance, spec_hash)

__all__ = [
    "TraceKind", "TraceSink", "collect", "merge_events",
    "Span", "TraceRun", "assemble_spans",
    "events_to_trace", "save_trace", "validate_trace",
    "events_summary", "timeline", "timeline_to_csv", "to_prometheus",
    "PhaseTimer", "compile_run_split", "call_breakdown",
    "provenance", "spec_hash",
]

"""The event-trace rail: record layout, host sink, collection scope.

Counterpart of `repro.telemetry.rail`. A traced engine call (the
``trace=True`` keyword of `repro_torch.core.engine.simulate` and
`repro_torch.cluster.engine.simulate_cluster`) writes one fixed-width
record per *processed* event of each lane and hands host copies of them
to the active `TraceSink`:

* the eager loops (the CPU route, and every policy without a device
  loop) stage one (L, ·) row a step and flush a (L, SEG, ·) block a
  segment, rows of lanes that made no progress marked unused (kind -1),
  as the JAX engines flush their segment overlay;
* the traced variants of the event-loop kernel (K0) write each lane's
  records into a per-lane window of one buffer on the card, in event
  order, and the wrapper copies the buffer back once a launch
  (`TraceSink.append_lanes`).

Either way each lane's records reach the sink in event order, so
`TraceSink.lane_events` is the lane's stream. With ``trace=False`` (the
default) no record is made and no traced kernel is launched: the results
are those of the untraced engines, bitwise.

Record layout (int32 x TR_RI + float64 x TR_RF):

===========  ===========================================================
field        meaning
===========  ===========================================================
TR_KIND      `TraceKind` code; -1 rows are unused block rows
TR_RID       request id (-1 for rid-less events: cold-done, churn)
TR_FN        function id (-1 when not applicable)
TR_NODE      node id (-1 on the single-node tier; the static cluster
             tier patches the node in host-side)
TR_AUX       kind-dependent detail. EXEC: 0 ok / 1 fail-retry /
             2 fail-exhausted, +4 timeout. CHURN: 1 node came up /
             0 went down. Arrival-class events: bitfield -- 1 cold
             start begun, 2 queued, 4 shed, 8 overflow-dropped.
TR_QLEN      queued requests after the event (event node's total)
TR_BUSY      busy slots after the event (event node)
TR_WARM      warm idle containers after the event (event node)
TR_SEQ       per-lane processed-event sequence number (1-based)
TF_T         simulation time of the event
TF_DT        execution time (EXEC events; 0 otherwise)
===========  ===========================================================
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional

import numpy as np


class TraceKind:
    """Event-kind codes shared by the engines' records and the span
    reassembler."""
    ARRIVAL = 0        # fresh arrival consumed (routed/admitted/parked)
    EXEC = 1           # an execution finished (any outcome; see AUX)
    COLD = 2           # a cold container finished warming
    TIMER = 3          # a keep-alive / re-arm timer fired
    RETRY = 4          # a retry-rail head fired (re-entry)
    NODE_ARRIVAL = 5   # a delayed send landed on its node
    REROUTE = 6        # a churn-drained request re-entered routing
    CHURN = 7          # a node toggled up/down

    NAMES = ("ARRIVAL", "EXEC", "COLD", "TIMER", "RETRY",
             "NODE_ARRIVAL", "REROUTE", "CHURN")


# int32 record fields
(TR_KIND, TR_RID, TR_FN, TR_NODE, TR_AUX, TR_QLEN, TR_BUSY, TR_WARM,
 TR_SEQ) = range(9)
TR_RI = 9
# float64 record fields
TF_T, TF_DT = range(2)
TR_RF = 2

# TR_AUX bits on arrival-class events (ARRIVAL / RETRY / NODE_ARRIVAL
# / REROUTE / TIMER)
AUX_COLD = 1       # the event started a cold container
AUX_QUEUED = 2     # a request was pushed onto a queue
AUX_SHED = 4       # a request was shed (terminal)
AUX_OVERFLOW = 8   # a request was dropped on a full queue (error mode)
# TR_AUX on EXEC events
AUX_FAIL_RETRY = 1
AUX_FAIL_EXHAUSTED = 2
AUX_TIMEOUT = 4

_FIELDS_I = ("kind", "rid", "fn", "node", "aux", "qlen", "busy",
             "warm", "seq")
_FIELDS_F = ("t", "dt")


class TraceSink:
    """Per-collection-scope accumulator of the records handed over by
    traced engine calls.

    ``blocks`` holds, in arrival order, either (tr_i, tr_f) pairs of
    (L, S, TR_RI) int32 / (L, S, TR_RF) float64 blocks (rows of kind -1
    unused), or (tr_i, tr_f, offsets) triples of one launch's records,
    lane l's at rows [offsets[l], offsets[l + 1]) of (R, TR_RI) /
    (R, TR_RF) arrays."""

    def __init__(self):
        self.blocks: List[tuple] = []

    def append(self, tr_i, tr_f) -> None:
        self.blocks.append((np.array(tr_i, np.int32),
                            np.array(tr_f, np.float64)))

    def append_lanes(self, tr_i, tr_f, offsets) -> None:
        self.blocks.append((np.array(tr_i, np.int32),
                            np.array(tr_f, np.float64),
                            np.array(offsets, np.int64)))

    @property
    def n_lanes(self) -> int:
        if not self.blocks:
            return 0
        b = self.blocks[0]
        return len(b[2]) - 1 if len(b) == 3 else b[0].shape[0]

    def lane_events(self, lane: int) -> dict:
        """Per-lane columnar event arrays (unused rows -- kind -1 --
        filtered), in processed-event order."""
        ii, ff = [], []
        for b in self.blocks:
            if len(b) == 3:
                lo, hi = int(b[2][lane]), int(b[2][lane + 1])
                ii.append(b[0][lo:hi])
                ff.append(b[1][lo:hi])
            else:
                ii.append(b[0][lane])
                ff.append(b[1][lane])
        if not ii:
            i = np.zeros((0, TR_RI), np.int32)
            f = np.zeros((0, TR_RF), np.float64)
        else:
            i = np.concatenate(ii)
            f = np.concatenate(ff)
        keep = i[:, TR_KIND] >= 0
        i, f = i[keep], f[keep]
        out = {name: i[:, col].copy()
               for col, name in enumerate(_FIELDS_I)}
        out.update({name: f[:, col].copy()
                    for col, name in enumerate(_FIELDS_F)})
        return out


# the active sink: one scope at a time (the runners serialise traced
# engine calls); the lock keeps nested or concurrent scopes honest
_SINK: Optional[TraceSink] = None
_SCOPE_LOCK = threading.Lock()


def active_sink() -> Optional[TraceSink]:
    """The sink of the open `collect` scope, None outside one."""
    return _SINK


@contextmanager
def collect():
    """Scope that captures the records of every traced engine call made
    within it (the calls copy their records back before they return).
    Scopes are exclusive: traced engine calls must not run
    concurrently."""
    global _SINK
    sink = TraceSink()
    with _SCOPE_LOCK:
        prev, _SINK = _SINK, sink
        try:
            yield sink
        finally:
            _SINK = prev


def merge_events(events: List[dict]) -> dict:
    """Merge several per-lane event streams into one, stably sorted by
    (time, sequence) -- used by the static cluster tier, where one
    logical cell is K independent single-node streams."""
    if not events:
        return {name: np.zeros((0,),
                               np.int32 if name in _FIELDS_I
                               else np.float64)
                for name in _FIELDS_I + _FIELDS_F}
    cat = {k: np.concatenate([e[k] for e in events])
           for k in events[0]}
    order = np.lexsort((cat["seq"], cat["t"]))
    return {k: v[order] for k, v in cat.items()}

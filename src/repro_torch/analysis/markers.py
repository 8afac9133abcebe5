"""Marker dimensions: which logical axis a concrete size came from.

The audit builds the engines' state at small, pairwise-distinct sizes
(the JAX package's markers, `repro.analysis.markers`) so that every
dimension of every tensor says which axis it came from: ``769`` can only
be the trace length N, ``11`` only the function count F. N is prime and
larger than every other marker, so a dimension that is a multiple of N,
or at least N (the eager loops' N + 1 columns, a traced window of
``L * trace_capacity(N)`` rows), can only come from the trace length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# The port's constant dimensions (`repro_torch.core.engine`,
# `kernels.event_loop`): a tensor may carry them at any N. They win over
# a coincidental marker of the same size in a label.
ENGINE_DIMS = {64: "HIST_BINS", 9: "NCI", 32: "SEG"}


@dataclass(frozen=True)
class Markers:
    """Audit sizes: pairwise distinct; N prime and above the rest."""

    T: int = 2     # trace rows
    L: int = 3     # lanes
    K: int = 4     # cluster nodes
    C: int = 5     # slots a node
    F: int = 11    # functions
    Q: int = 97    # queue cap
    W: int = 256   # the JAX package's window override (inert here)
    N: int = 769   # requests a trace row
    E: int = 6     # churn toggle columns
    D: int = 8     # delay-schedule steps
    TL: int = 13   # timeline bins (the port's options)

    def scales_with_n(self, dim: int) -> bool:
        """A dimension that only the trace length makes: a multiple of
        N, or at least N."""
        return dim >= self.N or (dim > 0 and dim % self.N == 0)

    def label(self, dim: int) -> str:
        """The axis of a concrete size: ``N``, ``N+1`` or ``~N(size)``
        for the trace length, an engine constant's name, a marker's
        name, else the number itself."""
        if self.scales_with_n(dim):
            if dim in (self.N, self.N + 1):
                return "N" if dim == self.N else "N+1"
            return f"~N({dim})"
        if dim in ENGINE_DIMS:
            return ENGINE_DIMS[dim]
        for name in ("T", "L", "K", "C", "F", "Q", "W", "E", "D", "TL"):
            if dim == getattr(self, name):
                return name
        return str(dim)

    def shape_class(self, shape: Tuple[int, ...]) -> Tuple[str, ...]:
        return tuple(self.label(d) for d in shape)


MARKERS = Markers()

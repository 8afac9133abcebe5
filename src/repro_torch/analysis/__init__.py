"""The invariant audit of the port (counterpart of `repro.analysis`).

The JAX package reads its jaxprs and HLO; the port has neither, so each
of its gates is restated on what torch and the card have:

* **carry budget** -- every tensor of the eager loops' state and every
  buffer a K0 launch allocates, built at the marker shapes, is
  O(F + C + HIST_BINS) a lane unless it is a documented rail of the
  engine module's ``CARRY_RAILS`` (`carries`); K0's layouts do not
  depend on N;
* **dtype policy** -- every floating tensor of that state is float64,
  and the spec's and runners' lowerings have the port's boundary dtypes
  (`dtypes`);
* **f32 in the compiled engine** -- K0's machine code (``cuobjdump
  -sass``) holds no f32 arithmetic beyond what the toolkit's f64
  division needs, counted a kernel (`sass`; a card only);
* **recompilation** -- a grid of topologies launches once a policy a
  tier, in the expected K0 forms; K4a/K4b's geometries for the served
  models are pinned (`recompile`);
* **telemetry off** -- the untraced units are built without the rail,
  and an untraced eager run never flushes (`telemetry_gate`);
* **deprecation lint** -- an AST scan for JAX and JAX-package imports
  and the retired surface (`lint`).

``python -m repro_torch.analysis [--quick] [--device cuda|cpu] [--gates
...] [--out report.json]`` runs them; see docs/analysis_torch.md.
"""
from repro_torch.analysis.report import GATES, run_gates

__all__ = ["GATES", "run_gates"]

"""Scheduling core of the port.

* The lane-batched engine (`engine`), its policy kernels (`policies`)
  and the request/trace data model (`request`).
* The paper's Python event-driven core, JAX-free copies of
  `repro.core`'s: events, server slots, the policy interface and its
  registry ``POLICIES`` (ESFF, ESFF-H and the baselines register on
  import, as in the JAX package), metrics and `simulator.simulate`.
  The live serving engine (`repro_torch.serving`) drives it.
"""
from repro_torch.core import baselines as _baselines  # noqa: F401
from repro_torch.core import esff as _esff            # noqa: F401
from repro_torch.core import esff_h as _esff_h        # noqa: F401

"""PyTorch/CUDA port of the ESFF edge scheduling system.

Counterpart of the JAX package `repro`, which stays the reference; the
port imports neither JAX nor anything of `repro`. Ported so far: the
single-node engine with the ESFF policy (`repro_torch.core`), its FRP
selection as a CUDA kernel (`repro_torch.kernels.frp_select`), the
trace generator (`repro_torch.traces`) and the experiment API
(`repro_torch.api`). Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

"""PyTorch/CUDA port of the ESFF edge scheduling system.

Counterpart of the JAX package `repro`, which stays the reference; the
port imports neither JAX nor anything of `repro`. Ported so far: the
single-node engine with every policy and the engine options
(`repro_torch.core`; on the card one event-loop kernel,
`repro_torch.kernels.event_loop`), the static and dynamic cluster tiers
with churn, delay schedules and the resilience layer
(`repro_torch.cluster`), the telemetry rail (`repro_torch.telemetry`),
the trace generator (`repro_torch.traces`),
the experiment API (`repro_torch.api`) and live serving of the dense,
ssm and hybrid model families (`repro_torch.serving`,
`repro_torch.models`). Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

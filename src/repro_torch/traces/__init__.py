from repro_torch.traces.generator import (synth_azure_arrays,
                                          synth_azure_trace,
                                          trace_from_lists)

__all__ = ["synth_azure_arrays", "synth_azure_trace", "trace_from_lists"]

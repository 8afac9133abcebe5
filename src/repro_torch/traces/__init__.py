from repro_torch.traces.generator import (synth_azure_arrays,
                                          synth_azure_trace,
                                          synth_azure_windows,
                                          trace_from_lists)

__all__ = ["synth_azure_arrays", "synth_azure_trace",
           "synth_azure_windows", "trace_from_lists"]

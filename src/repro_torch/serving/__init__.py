"""Live serving: the paper's scheduler driving real models on the
device (`engine.EdgeServingEngine`, `instance.ModelInstance`)."""
from repro_torch.serving.engine import EdgeServingEngine, ServedFunction

__all__ = ["EdgeServingEngine", "ServedFunction"]

"""The dense model stack of the port: config, layers, KV cache, model
and the JAX weight converter."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]

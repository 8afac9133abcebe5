"""The model stack of the port (dense, ssm and hybrid families):
config, layers, Mamba2 block, caches, model and the JAX weight
converter."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]

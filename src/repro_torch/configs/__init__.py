"""The architecture configs of the port (``get_arch(name)``): the
dense, ssm and hybrid families; each ``<id>.py`` is the JAX package's
config, field for field."""
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "get_arch"]

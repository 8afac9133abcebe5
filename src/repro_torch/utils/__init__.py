from repro_torch.utils.registry import Registry
from repro_torch.utils.logging_ import get_logger
from repro_torch.utils.device import resolve_device

__all__ = ["Registry", "get_logger", "resolve_device"]

"""Pluggable policy registry over the engine's kernel table
(`repro_torch.core.policies.KERNELS`): `register_policy` adds a
`PolicyKernel` instance under a name, and `ExperimentSpec.policies`
then accepts it like a built-in."""
from __future__ import annotations

from typing import List

def _kernels() -> dict:
    from repro_torch.core.policies import KERNELS
    return KERNELS


def available_policies() -> List[str]:
    """Registered policy names (built-ins + `register_policy` adds)."""
    return sorted(_kernels())


def get_kernel(name: str):
    """Kernel registered under ``name``; KeyError (listing what exists)
    for an unknown name."""
    kernels = _kernels()
    if name in kernels:
        return kernels[name]
    raise KeyError(f"unknown policy {name!r}; registered policies: "
                   f"{sorted(kernels)} (add your own with "
                   "repro_torch.api.register_policy)")


def register_policy(name: str, kernel, *, replace: bool = False):
    """Register a `repro_torch.core.engine.PolicyKernel` instance under
    ``name`` (``replace=True`` to overwrite an existing name). Returns
    ``kernel``."""
    from repro_torch.core.engine import PolicyKernel
    if not isinstance(kernel, PolicyKernel):
        raise TypeError(
            f"register_policy({name!r}): expected a PolicyKernel "
            f"*instance* (got {type(kernel).__name__})")
    if not name or not isinstance(name, str):
        raise ValueError("register_policy: name must be a non-empty "
                         "string")
    kernels = _kernels()
    if name in kernels and not replace:
        raise ValueError(
            f"register_policy: policy {name!r} is already registered "
            f"(to {type(kernels[name]).__name__}); pass replace=True "
            "to overwrite deliberately")
    kernels[name] = kernel
    return kernel


def unregister_policy(name: str) -> None:
    """Remove a registered policy (built-ins included)."""
    kernels = _kernels()
    if name not in kernels:
        raise KeyError(f"unregister_policy: {name!r} is not registered")
    del kernels[name]

"""Fused RMSNorm, plain (K4a) and with the residual add (K4b): the CUDA
kernel's wrappers and their plain PyTorch versions.

Port of the TPU kernels `repro.kernels.rmsnorm.rmsnorm` and
`rmsnorm_residual` (Pallas), with their contract: the sum of squares,
the rsqrt and the product with the weight in f32, one cast to x's dtype
at the end. (The JAX model's own `rms_norm`, and `kernels/ref.py`'s
`rmsnorm_ref`, cast before the weight product instead: in bf16 the two
differ by one rounding.) The kernel is ``csrc/rmsnorm.cu``; see its
header for the bound and the design.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``) or raises. There is no fallback from a failed
build or launch to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_D = 8192
DTYPES = tuple(_build.DTYPE_CODE)
_P = _build.PTR
_ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, _P]


def rmsnorm_plain(x, weight, eps: float = 1e-6):
    """Plain version of K4a (the Pallas kernel's arithmetic)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * weight.to(torch.float32)).to(x.dtype)


def rmsnorm_residual_plain(x, residual, weight, eps: float = 1e-6):
    """Plain version of K4b: returns (normed, new residual)."""
    s = x.to(torch.float32) + residual.to(torch.float32)
    var = s.square().mean(-1, keepdim=True)
    normed = s * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return normed.to(x.dtype), s.to(x.dtype)


def _check_inputs(name, x, residual, weight):
    dev = x.device
    _build.check_tensor(f"{name}: x", x, DTYPES, dev)
    D = x.shape[-1] if x.dim() >= 1 else 0
    if not 1 <= D <= MAX_D or x.numel() == 0:
        raise ValueError(f"{name}: x must be (..., D) with 1 <= D <= "
                         f"{MAX_D} and at least one row, got "
                         f"{tuple(x.shape)}")
    if residual is not None:
        _build.check_tensor(f"{name}: residual", residual, (x.dtype,), dev)
        if residual.shape != x.shape:
            raise ValueError(f"{name}: residual shape "
                             f"{tuple(residual.shape)} != x shape "
                             f"{tuple(x.shape)}")
    _build.check_tensor(f"{name}: weight", weight, DTYPES, dev, ndim=1)
    if weight.shape[0] != D:
        raise ValueError(f"{name}: weight {tuple(weight.shape)}, expected "
                         f"({D},)")
    return dev, D


def _launch(name, x, residual, weight, eps):
    dev, D = x.device, x.shape[-1]
    fn = _build.c_entry("rmsnorm", "rmsnorm", _ARGTYPES)
    _build.require_cuda(name, dev)
    y = torch.empty_like(x)
    res = None if residual is None else torch.empty_like(x)
    code = _build.DTYPE_CODE
    rc = fn(code[x.dtype], code[weight.dtype], x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            weight.data_ptr(), y.data_ptr(),
            None if res is None else res.data_ptr(), x.numel() // D, D,
            float(eps), _build.stream_of(dev))
    _build.launch_check(rc, name)
    return y, res


def rmsnorm(x, weight, *, eps: float = 1e-6):
    """K4a over the last dim: x (..., D) f32/bf16, weight (D,) f32/bf16.
    Returns x's shape and dtype."""
    dev, _ = _check_inputs("rmsnorm", x, None, weight)
    if dev.type == "cpu":
        rmsnorm.plain_calls += 1
        return rmsnorm_plain(x, weight, eps)
    y, _ = _launch("rmsnorm", x, None, weight, eps)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.plain_calls = 0


def rmsnorm_residual(x, residual, weight, *, eps: float = 1e-6):
    """K4b: (x + residual) -> RMSNorm. Returns (normed, new residual),
    both in x's shape and dtype."""
    dev, _ = _check_inputs("rmsnorm_residual", x, residual, weight)
    if dev.type == "cpu":
        rmsnorm_residual.plain_calls += 1
        return rmsnorm_residual_plain(x, residual, weight, eps)
    y, res = _launch("rmsnorm_residual", x, residual, weight, eps)
    rmsnorm_residual.launches += 1
    return y, res


rmsnorm_residual.launches = 0
rmsnorm_residual.plain_calls = 0

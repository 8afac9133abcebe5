"""Flash attention for prefill (K2): the CUDA kernel's wrapper and its
plain PyTorch version.

Port of the TPU kernel `repro.kernels.flash_attention.flash_attention`
(Pallas): causal or bidirectional attention with an online softmax,
grouped-query (q head h reads kv head h // G), f32 accumulation, the
output in q's dtype. In bf16 the kernel runs on the tensor cores
(wgmma, its tiles brought in by TMA) and rounds the softmax weights to
bf16 for the value product, one rounding the plain version (all f32)
does not make. The causal mask compares absolute indices from 0 (q row
i sees positions j <= i), as the TPU kernel's does. The kernel is ``csrc/flash_attention.cu``; see its
header for the bound and the design.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``) or raises. There is no fallback from a failed
build or launch to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = tuple(_build.DTYPE_CODE)
_P = _build.PTR
_I = ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
             _P]


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None):
    """Plain version (`repro.kernels.ref.flash_attention_ref`, with the
    kernel's ``* scale``)."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale or 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(g, dim=2).to(torch.float32)
    vf = v.repeat_interleave(g, dim=2).to(torch.float32)
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kf) * scale
    if causal:
        pos_q = torch.arange(S, device=q.device)
        pos_k = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos_q[:, None] >= pos_k[None, :]),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q (B, S, H, D); k, v (B, T, KVH, D) -> (B, S, H, D). H % KVH ==
    0, D in HEAD_DIMS; f32 or bf16, one dtype for all three."""
    name = "flash_attention"
    dev = q.device
    _build.check_tensor(f"{name}: q", q, DTYPES, dev, ndim=4)
    for nm, x in (("k", k), ("v", v)):
        _build.check_tensor(f"{name}: {nm}", x, (q.dtype,), dev, ndim=4)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be (B={B}, T, KVH, "
                         f"D={D})")
    if min(B, S, T, KVH) < 1 or H % KVH != 0:
        raise ValueError(f"{name}: need B, S, T >= 1 and H ({H}) a "
                         f"multiple of KVH ({KVH})")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}, kernel takes {HEAD_DIMS}")
    scale = scale or 1.0 / math.sqrt(D)
    if dev.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    fn = _build.c_entry("flash_attention", "flash_attention", _ARGTYPES)
    _build.require_cuda(name, dev)
    # the bf16 kernel's TMA tensor maps need 16-byte aligned addresses
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start at 16-byte "
                         "aligned addresses")
    out = torch.empty_like(q)
    rc = fn(_build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, T, H, KVH, D, float(scale), int(causal),
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain_calls = 0

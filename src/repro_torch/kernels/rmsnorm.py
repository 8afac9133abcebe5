"""Fused RMSNorm, plain (K4a) and with the residual add (K4b): the CUDA
kernel's wrappers and their plain PyTorch versions.

Port of the TPU kernels `repro.kernels.rmsnorm.rmsnorm` and
`rmsnorm_residual` (Pallas), with their contract: the sum of squares,
the rsqrt and the product with the weight in f32, one cast to x's dtype
at the end. (The JAX model's own `rms_norm`, and `kernels/ref.py`'s
`rmsnorm_ref`, cast before the weight product instead: in bf16 the two
differ by one rounding.) The kernel is ``csrc/rmsnorm.cu``; see its
header for the bound and the design. `_plan` chooses its body and
geometry from the shape, the dtypes and the pointers' alignment.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``) or raises. There is no fallback from a failed
build or launch to the plain version. A decode step calls these
wrappers ~140 times a token, so the checks read each input's
attributes once, the C entry is bound once and the stream is taken as
its raw handle.

Training: when x, the residual or the weight requires a gradient (and
grad mode is on), `rmsnorm` and `rmsnorm_residual` run through
`RMSNorm` and `RMSNormResidual`, ``torch.autograd.Function``s whose
backward is `rmsnorm_backward` / `rmsnorm_residual_backward`, the
hand-written backward kernel (``csrc/rmsnorm_bwd.cu``: dx, and dw
reduced in two deterministic stages; each wrapper counts its own
``launches``). On CPU tensors the backward is the plain one: autograd
through `rmsnorm_plain` / `rmsnorm_residual_plain` (``plain_calls``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_D = 8192
DTYPES = tuple(_build.DTYPE_CODE)
_CODE = _build.DTYPE_CODE
_P = _build.PTR
# x, r, w, y, res; R, D, the two dtype codes and the geometry as
# pointer-sized words (ctypes converts a c_void_p about twice as fast as
# a c_int); eps; the stream
_ARGTYPES = [_P] * 13 + [ctypes.c_float, _P]

# The vector body's instances: vectors a thread (the kernel's VPT), and
# the most threads a block of each may have (its __launch_bounds__).
VECTORS = (1, 2, 3, 4, 6, 8)


def max_threads(vpt: int) -> int:
    return 1024 if vpt <= 2 else (512 if vpt <= 4 else 256)


# The shape classes' geometry, chosen by measuring candidates on an H100
# (scripts/rmsnorm_timing.py --sweep; the numbers are in PERF.md).
# Narrow rows (at most 32 vectors) take blocks of NARROW_THREADS and at most
# NARROW_BLOCKS_PER_SM blocks a SM, which then walk the rest of the rows.
# A wide row takes one vector a thread while every row's threads fit on
# the card at once (FEW_ROWS_THREADS a SM); otherwise one block a row of
# about WIDE_ROW_THREADS threads (D / 8 / WIDE_ROW_THREADS vectors a
# thread, at least one) and at most WIDE_BLOCKS_PER_SM blocks a SM.
NARROW_THREADS = 128
NARROW_BLOCKS_PER_SM = 8
FEW_ROWS_THREADS = 2048
WIDE_ROW_THREADS = 192
WIDE_BLOCKS_PER_SM = 4


class Plan(NamedTuple):
    """How the kernel covers x (R, D): ``body`` "vector" (16-byte vectors
    in registers) or "general" (scalar loads, the row in shared memory);
    ``threads_per_row`` (G), ``rows_per_block``, ``vectors_per_thread``
    (VPT, 0 for the general body) and ``grid`` blocks, which walk the
    rows ``rows_per_block`` at a time with a grid stride."""
    body: str
    threads_per_row: int
    rows_per_block: int
    vectors_per_thread: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def _plan(R: int, D: int, x_dtype, w_dtype, aligned: bool,
          n_sms: int = 132) -> Plan:
    """The body and geometry for x (R, D) of ``x_dtype`` under a weight
    of ``w_dtype``; ``aligned`` says that every pointer (x, r, w, y,
    res) is 16-byte aligned. The vector body takes D a multiple of the
    vector's elements (8 bf16 or 4 f32) at aligned pointers; everything
    else takes the general body."""
    V = 16 // x_dtype.itemsize
    if not aligned or D % V:
        threads = min(max(_cdiv(_cdiv(D, 4), 32) * 32, 32), 256)
        return Plan("general", threads, 1, 0, R)
    nv = D // V
    if nv <= 32:
        # narrow: a power-of-two group of lanes a row, several rows a warp
        G = 1 << (nv - 1).bit_length()
        threads = min(NARROW_THREADS, max(32, _cdiv(R * G, 32) * 32))
        rows = threads // G
        return Plan("vector", G, rows, 1,
                    min(_cdiv(R, rows), NARROW_BLOCKS_PER_SM * n_sms))
    vpt = next(v for v in VECTORS if v * 1024 >= nv)
    G = _cdiv(_cdiv(nv, vpt), 32) * 32
    if R * G <= FEW_ROWS_THREADS * n_sms:
        # few rows: one vector a thread (two for f32 at D > 4096)
        return Plan("vector", G, 1, vpt, R)
    # many wide rows: one block a row, the grid walking the rows
    want = max(1, nv // WIDE_ROW_THREADS)
    vpt = next((v for v in VECTORS if v >= want), VECTORS[-1])
    G = _cdiv(_cdiv(nv, vpt), 32) * 32
    vpt = next(v for v in VECTORS if v * G >= nv)
    return Plan("vector", G, 1, vpt, min(R, WIDE_BLOCKS_PER_SM * n_sms))


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


def _check(name, what, t, dtypes, x=None):
    """Raise unless ``t`` is a contiguous tensor with a dtype in
    ``dtypes`` (on x's device, when ``x`` is given); return its CUDA
    index, -1 off CUDA."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    i = t.get_device()
    if x is not None and (i != x.get_device()
                          or (i < 0 and t.device != x.device)):
        raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} is not contiguous")
    return i


def _check_inputs(name, x, residual, weight) -> int:
    """Raise on anything the kernel does not take; return x's CUDA
    index, -1 off CUDA. Reads each input's attributes once: a decode
    step calls the wrappers ~140 times a token."""
    index = _check(name, "x", x, _CODE)
    shape = x.shape
    D = shape[-1] if shape else 0
    if not 1 <= D <= MAX_D or x.numel() == 0:
        raise ValueError(f"{name}: x must be (..., D) with 1 <= D <= "
                         f"{MAX_D} and at least one row, got "
                         f"{tuple(shape)}")
    if residual is not None:
        _check(name, "residual", residual, (x.dtype,), x)
        if residual.shape != shape:
            raise ValueError(f"{name}: residual shape "
                             f"{tuple(residual.shape)} != x shape "
                             f"{tuple(shape)}")
    _check(name, "weight", weight, _CODE, x)
    if weight.shape != (D,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)}, expected "
                         f"({D},)")
    return index


_FN = None   # the C entry, bound at the first launch


def _entry():
    global _FN
    if _FN is None:
        _FN = _build.c_entry("rmsnorm", "rmsnorm", _ARGTYPES)
    return _FN


@functools.lru_cache(maxsize=4096)
def _words(R: int, D: int, x_dtype, w_dtype, aligned: bool, index: int):
    """The C entry's integer words for x (R, D) on CUDA device ``index``:
    R, D, the two dtype codes and `_plan`'s geometry (vectors a thread,
    threads a row, rows a block, grid)."""
    p = _plan(R, D, x_dtype, w_dtype, aligned, _build.sm_count(index))
    return (R, D, _CODE[x_dtype], _CODE[w_dtype], p.vectors_per_thread,
            p.threads_per_row, p.rows_per_block, p.grid)


def _launch(name, x, residual, weight, y, res, eps, index):
    """Launch the kernel into y (and res) on the current stream of CUDA
    device ``index``, with `_plan`'s geometry; raise off CUDA (after
    binding the entry, so that a missing build is what a caller sees
    first)."""
    fn = _entry()
    if index < 0:
        _build.require_cuda(name, x.device)
    D = x.shape[-1]
    xp, wp, yp = x.data_ptr(), weight.data_ptr(), y.data_ptr()
    rp = sp = 0
    if residual is not None:
        rp, sp = residual.data_ptr(), res.data_ptr()
    words = _words(x.numel() // D, D, x.dtype, weight.dtype,
                   not (xp | wp | yp | rp | sp) & 15, index)
    rc = fn(xp, rp, wp, yp, sp, *words, eps, _build.stream_of(index))
    _build.launch_check(rc, name)


def rmsnorm(x, weight, *, eps: float = 1e-6):
    """K4a over the last dim: x (..., D) f32/bf16, weight (D,) f32/bf16.
    Returns x's shape and dtype. Through `RMSNorm` when a gradient is
    wanted."""
    if _wants_grad(x, weight):
        return RMSNorm.apply(x, weight, eps)
    return _rmsnorm(x, weight, eps)


def _rmsnorm(x, weight, eps):
    index = _check_inputs("rmsnorm", x, None, weight)
    if index < 0 and x.is_cpu:
        rmsnorm.plain_calls += 1
        return rmsnorm_plain(x, weight, eps)
    y = torch.empty_like(x)
    _launch("rmsnorm", x, None, weight, y, None, eps, index)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.plain_calls = 0


def rmsnorm_residual(x, residual, weight, *, eps: float = 1e-6):
    """K4b: (x + residual) -> RMSNorm. Returns (normed, new residual),
    both in x's shape and dtype. Through `RMSNormResidual` when a gradient
    is wanted."""
    if _wants_grad(x, residual, weight):
        return RMSNormResidual.apply(x, residual, weight, eps)
    return _rmsnorm_residual(x, residual, weight, eps)


def _rmsnorm_residual(x, residual, weight, eps):
    index = _check_inputs("rmsnorm_residual", x, residual, weight)
    if index < 0 and x.is_cpu:
        rmsnorm_residual.plain_calls += 1
        return rmsnorm_residual_plain(x, residual, weight, eps)
    y, res = torch.empty_like(x), torch.empty_like(x)
    _launch("rmsnorm_residual", x, residual, weight, y, res, eps, index)
    rmsnorm_residual.launches += 1
    return y, res


rmsnorm_residual.launches = 0
rmsnorm_residual.plain_calls = 0


# ------------------------------------------------------------ backward
# x, r, w, g, gres, dx, dw, partial; R, D, the two dtype codes and the
# geometry (vectors a thread, threads a row, rows a block, grid) as
# pointer-sized words; eps; the stream
_BWD_ARGTYPES = [_P] * 16 + [ctypes.c_float, _P]
# The backward's vector body: vectors a thread (the kernel's VPT), and
# the most threads a block of each may have (its __launch_bounds__).
BWD_VECTORS = (1, 2, 3, 4)


def bwd_max_threads(vpt: int) -> int:
    return 1024 if vpt <= 1 else (512 if vpt <= 2 else 256)


# The backward's geometry by shape class (scripts/rmsnorm_timing.py
# --bwd_sweep measures the candidates on an H100; the numbers are in
# PERF.md). Narrow rows (at most 32 vectors) take a power-of-two group of
# lanes a row, blocks of BWD_NARROW_THREADS and at most
# BWD_NARROW_BLOCKS_PER_SM blocks a SM. Wide rows take the fewest vectors a
# thread that keep a row's group within BWD_WIDE_ROW_THREADS threads,
# about BWD_WIDE_THREADS threads a block (whole rows) and at most
# BWD_WIDE_BLOCKS_PER_SM blocks a SM. Every block writes one partial row
# of dw, so the grid is also the dw pass's depth. The general body (odd
# widths, pointers off 16 bytes): a warp a row up to BWD_WARP_ROW_D
# elements (8 rows a block of 256 threads), else the block a row, at most
# BWD_GENERAL_BLOCKS_PER_SM blocks a SM.
BWD_NARROW_THREADS = 512
BWD_NARROW_BLOCKS_PER_SM = 2
BWD_WIDE_ROW_THREADS = 320
BWD_WIDE_THREADS = 960
BWD_WIDE_BLOCKS_PER_SM = 1
BWD_THREADS = 256
BWD_WARP_ROW_D = 1024
BWD_GENERAL_BLOCKS_PER_SM = 4


# the backward's launches by body (both wrappers), beside their counts
bwd_body_launches = {"vector": 0, "general": 0}


@functools.lru_cache(maxsize=4096)
def _bwd_plan(R: int, D: int, x_dtype, aligned: bool,
              n_sms: int = 132) -> Plan:
    """The backward kernel's body and geometry for x (R, D) of
    ``x_dtype``; ``aligned`` says that every pointer (x, r, w, g, gres,
    dx) is 16-byte aligned. The vector body takes D a multiple of the
    vector's elements (8 bf16 or 4 f32) at aligned pointers, with a row's
    group within the instances' blocks; everything else takes the general
    body."""
    V = 16 // x_dtype.itemsize
    nv = D // V
    if aligned and not D % V:
        if nv <= 32:
            # narrow: a power-of-two group of lanes a row, several rows a
            # warp
            G = 1 << (nv - 1).bit_length()
            threads = min(BWD_NARROW_THREADS, max(32, _cdiv(R * G, 32) * 32))
            rows = threads // G
            return Plan("vector", G, rows, 1,
                        min(_cdiv(R, rows), BWD_NARROW_BLOCKS_PER_SM * n_sms))
        for vpt in BWD_VECTORS:
            G = _cdiv(_cdiv(nv, vpt), 32) * 32
            if G <= min(BWD_WIDE_ROW_THREADS, bwd_max_threads(vpt)):
                rows = max(1, min(BWD_WIDE_THREADS,
                                  bwd_max_threads(vpt)) // G)
                return Plan("vector", G, rows, vpt,
                            min(_cdiv(R, rows),
                                BWD_WIDE_BLOCKS_PER_SM * n_sms))
    G = 32 if D <= BWD_WARP_ROW_D else BWD_THREADS
    rows = BWD_THREADS // G
    return Plan("general", G, rows, 0,
                min(_cdiv(R, rows), BWD_GENERAL_BLOCKS_PER_SM * n_sms))


_BWD_FN = None   # the backward's C entry, bound at its first launch


def _bwd_entry():
    global _BWD_FN
    if _BWD_FN is None:
        _BWD_FN = _build.c_entry("rmsnorm_bwd", "rmsnorm_backward",
                                 _BWD_ARGTYPES)
    return _BWD_FN


@functools.lru_cache(maxsize=4096)
def _bwd_words(R: int, D: int, x_dtype, w_dtype, aligned: bool,
               index: int):
    """`_bwd_plan`'s body for x (R, D) on CUDA device ``index``, and the
    backward entry's integer words: R, D, the two dtype codes and the
    geometry (vectors a thread, threads a row, rows a block, grid)."""
    p = _bwd_plan(R, D, x_dtype, aligned, _build.sm_count(index))
    return p.body, (R, D, _CODE[x_dtype], _CODE[w_dtype],
                    p.vectors_per_thread, p.threads_per_row,
                    p.rows_per_block, p.grid)


def rmsnorm_backward_plain(x, weight, g, eps: float = 1e-6):
    """Plain backward of K4a: (dx, dw) by autograd through
    `rmsnorm_plain`."""
    with torch.enable_grad():
        xr, wr = x.detach().requires_grad_(), weight.detach().requires_grad_()
        return torch.autograd.grad(rmsnorm_plain(xr, wr, eps), (xr, wr), g)


def rmsnorm_residual_backward_plain(x, residual, weight, g, gres=None,
                                    eps: float = 1e-6):
    """Plain backward of K4b: (dx, dw) by autograd through
    `rmsnorm_residual_plain`, for the gradients ``g`` of the normed output
    and ``gres`` of the new residual (None: not used); the residual's
    gradient equals dx."""
    with torch.enable_grad():
        xr, rr, wr = (t.detach().requires_grad_()
                      for t in (x, residual, weight))
        y, res = rmsnorm_residual_plain(xr, rr, wr, eps)
        outs, grads = ((y, res), (g, gres)) if gres is not None else \
            ((y,), (g,))
        dx, _, dw = torch.autograd.grad(outs, (xr, rr, wr), grads)
    return dx, dw


def _backward(name, x, residual, weight, g, gres, eps):
    """The checked backward of K4a (``residual`` None) or K4b: (dx, dw);
    the plain one on CPU tensors."""
    index = _check_inputs(name, x, residual, weight)
    for what, t in (("g", g), ("gres", gres)):
        if t is not None:
            _check(name, what, t, (x.dtype,), x)
            if t.shape != x.shape:
                raise ValueError(f"{name}: {what} shape {tuple(t.shape)} "
                                 f"!= x shape {tuple(x.shape)}")
    wrapper = rmsnorm_backward if residual is None else \
        rmsnorm_residual_backward
    if index < 0 and x.is_cpu:
        wrapper.plain_calls += 1
        if residual is None:
            return rmsnorm_backward_plain(x, weight, g, eps)
        return rmsnorm_residual_backward_plain(x, residual, weight, g, gres,
                                               eps)
    fn = _bwd_entry()
    if index < 0:
        _build.require_cuda(name, x.device)
    D = x.shape[-1]
    dx, dw = torch.empty_like(x), torch.empty_like(weight)
    xp, wp, gp, dxp = (x.data_ptr(), weight.data_ptr(), g.data_ptr(),
                       dx.data_ptr())
    rp = 0 if residual is None else residual.data_ptr()
    grp = 0 if gres is None else gres.data_ptr()
    body, words = _bwd_words(x.numel() // D, D, x.dtype, weight.dtype,
                             not (xp | rp | wp | gp | grp | dxp) & 15, index)
    partial = torch.empty((words[-1], D), dtype=torch.float32,
                          device=x.device)
    rc = fn(xp, rp, wp, gp, grp, dxp, dw.data_ptr(), partial.data_ptr(),
            *words, eps, _build.stream_of(index))
    _build.launch_check(rc, name)
    wrapper.launches += 1
    bwd_body_launches[body] += 1
    return dx, dw


def rmsnorm_backward(x, weight, g, *, eps: float = 1e-6):
    """The gradient of `rmsnorm` at (x, weight) for the output's gradient
    ``g``: (dx in x's dtype, dw in the weight's)."""
    return _backward("rmsnorm_backward", x, None, weight, g, None, eps)


rmsnorm_backward.launches = 0
rmsnorm_backward.plain_calls = 0


def rmsnorm_residual_backward(x, residual, weight, g, gres=None, *,
                              eps: float = 1e-6):
    """The gradient of `rmsnorm_residual` at (x, residual, weight) for
    the gradients ``g`` of the normed output and ``gres`` of the new
    residual (None when it is not used): (dx, dw); dx is also the
    residual's gradient."""
    return _backward("rmsnorm_residual_backward", x, residual, weight, g,
                     gres, eps)


rmsnorm_residual_backward.launches = 0
rmsnorm_residual_backward.plain_calls = 0


class RMSNorm(torch.autograd.Function):
    """K4a with its gradient (`rmsnorm_backward`); saves x and the
    weight."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, weight, g.contiguous(), eps=ctx.eps)
        return dx, dw, None


class RMSNormResidual(torch.autograd.Function):
    """K4b with its gradient (`rmsnorm_residual_backward`); saves x, the
    residual and the weight (the f32 sum is formed again from them)."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return _rmsnorm_residual(x, residual, weight, eps)

    @staticmethod
    def backward(ctx, g, gres):
        x, residual, weight = ctx.saved_tensors
        g = torch.zeros_like(x) if g is None else g.contiguous()
        dx, dw = rmsnorm_residual_backward(
            x, residual, weight, g, None if gres is None else
            gres.contiguous(), eps=ctx.eps)
        return dx, dx, dw, None


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)

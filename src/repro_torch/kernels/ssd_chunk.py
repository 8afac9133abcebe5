"""The Mamba2 SSD intra-chunk block (K5): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the TPU kernel `repro.kernels.ssd_chunk.ssd_chunk_kernel`
(Pallas), with its contract: per (batch, chunk, head) cell, in f32,

    scores = C B^T                                          (c x c)
    L[s,t] = exp(cum[s] - cum[t]) for s >= t, else 0 (masked before
             the exponent)
    y_diag = (scores * L * dt[t]) x                         (c x p)
    S      = (B * exp(cum[c-1] - cum) * dt)^T x,  stored as (p, n)

and the TPU entry's layout, except that B and C come by group: x
(b, nc, c, h, p), dt and cum (b, nc, c, h), B and C (b, nc, c, g, n),
head h reading group ``h // (h / g)`` (the TPU entry takes them
already repeated over the heads: the same function without the copy).
x may be f32 or bf16, B and C both f32 or both bf16 (bf16 only with x
in bf16: the served dtypes); every input is
widened exactly as it is read, as the TPU kernel widens them. dt and
cum are f32; both outputs are f32: y (b, nc, c, h, p) and the states
(b, nc, h, p, n). The kernel is ``csrc/ssd_chunk.cu``; see its header
for the bound and the design.

The kernel has two bodies, and `body_for` picks one by dtype and shape
class: "wgmma" (TMA + tensor cores, each f32 weight split into three
bf16 parts) for the served dtypes, x, B and C all bf16, with p = 64, n
a multiple of 64 (<= 256), c <= 256 and x, B, C starting on 16 bytes;
"cuda_core" (f32 FMA) for everything else: x or B and C in f32, other
head dims or state sizes, longer chunks. Both are hand-written kernels;
neither falls back to the other.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``, and by body in ``body_launches``) or raises.
There is no fallback from a failed build or launch to the plain
version.

Training: when an input requires a gradient (and grad mode is on),
`ssd_chunk` runs through `SSDChunk`, a ``torch.autograd.Function``
whose forward is the kernel as above and whose backward is
`ssd_chunk_backward`, the hand-written backward kernel
(``csrc/ssd_chunk_bwd.cu``; counted in its own ``launches``, and by body
in its ``body_launches``). Given the gradients dy (b, nc, c, h, p) and
dS (b, nc, h, p, n), both f32 (either may be None: zero), it returns dx
in x's dtype, ddt and dcum f32, and dB and dC in B's dtype, each summed
over the heads of its group. `body_for` picks its body too: "wgmma"
(TMA + tensor cores, every f32 operand in three bf16 parts) for x, B
and C in bf16 at the wgmma shape class, "cuda_core" (f32 FMA) for
everything else; neither falls back to the other. The JAX
package has no Pallas backward: ``jax.grad`` differentiates its plain
`repro.models.mamba.ssd_chunked`, which the plain backward
`ssd_chunk_backward_plain` (autograd through `ssd_chunk_plain`; counted
in ``plain_calls``) computes on CPU tensors. The serving call (no
gradient) stays the kernel alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_P = 64      # head dims the kernel takes
MAX_N = 256     # state sizes the kernel takes
DTYPES = tuple(_build.DTYPE_CODE)   # of x, and of B and C
BODIES = ("cuda_core", "wgmma")     # the entry's body codes 0, 1
# the shape class of the wgmma body
TC_P = 64
TC_N_STEP = 64
TC_MAX_C = 256
_P = _build.PTR
_I = ctypes.c_int
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _P]
# body, x dtype, B/C dtype, x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dB,
# dC, scratch, b * nc, c, h, g, p, n, stream
_BWD_ARGTYPES = [_I, _I, _I] + [_P] * 13 + [_I] * 6 + [_P]
# heads of one group that a block of the wgmma body's G pass walks
# (`kSliceHeads` of csrc/ssd_chunk_bwd.cu)
SLICE_HEADS = 8


def ssd_chunk_plain(x, dt, cum, B, C):
    """Plain version (`repro.kernels.ref.ssd_chunk_ref`, with B and C by
    group; every input widened to f32, or all in f64 where x is f64: the
    CPU's reference precision). Returns (y (b, nc, c, h, p), states (b,
    nc, h, p, n)), f32 (f64 for f64 inputs)."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    hg = h // g
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(f32).view(b, nc, c, g, hg, p)
    Bf, Cf = B.to(f32), C.to(f32)
    dtf = dt.view(b, nc, c, g, hg)
    cumf = cum.view(b, nc, c, g, hg)
    diff = cumf[:, :, :, None] - cumf[:, :, None, :]   # (b,nc,s,t,g,hg)
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    diff = diff.masked_fill(~causal[:, :, None, None], float("-inf"))
    scores = torch.einsum("bcsgn,bctgn->bcstg", Cf, Bf)
    y = torch.einsum("bcstgj,bctgj,bctgjp->bcsgjp",
                     scores[..., None] * torch.exp(diff), dtf, xf)
    decay_in = torch.exp(cumf[:, :, -1:] - cumf) * dtf  # (b,nc,c,g,hg)
    S = torch.einsum("bctgn,bctgj,bctgjp->bcgjpn", Bf, decay_in, xf)
    return y.reshape(b, nc, c, h, p), S.reshape(b, nc, h, p, n)


def body_for(x, B, C) -> str:
    """The body that takes these (checked) inputs: "wgmma" for x, B
    and C in bf16 at p = 64, n a multiple of 64 and c <= 256, with x, B
    and C starting on 16 bytes (the tensor maps' rule); else
    "cuda_core"."""
    c, p, n = x.shape[2], x.shape[4], B.shape[4]
    bf16 = torch.bfloat16
    aligned = not ((x.data_ptr() | B.data_ptr() | C.data_ptr()) & 15)
    if (x.dtype == bf16 and B.dtype == bf16 and p == TC_P
            and n % TC_N_STEP == 0 and c <= TC_MAX_C and aligned):
        return "wgmma"
    return "cuda_core"


def _bwd_scratch_floats(body, bnc, c, h, g, n):
    """f32 floats of one backward call's scratch on ``body``, as the
    library sizes it (``ssd_chunk_backward_scratch_floats``: the layout
    lives in ``csrc/ssd_chunk_bwd.cu`` alone)."""
    f = getattr(_build.load_library("ssd_chunk_bwd"),
                "ssd_chunk_backward_scratch_floats")
    if f.argtypes is None:
        f.argtypes = [_I] * 6
        f.restype = ctypes.c_longlong
    floats = f(BODIES.index(body), bnc, c, h, g, n)
    if floats < 0:
        raise ValueError(f"ssd_chunk_backward: no scratch size for {body} "
                         f"at bnc {bnc}, c {c}, h {h}, g {g}, n {n}")
    return floats


def _check(name, x, dt, cum, B, C):
    """Raise on anything the kernels do not take; returns (b, nc, c, h,
    p, g, n). On the CPU the plain version also takes every input in f64
    (a reference precision; the kernels take none)."""
    dev = x.device
    f32, dtypes = (torch.float32,), DTYPES
    if dev.type == "cpu" and x.dtype == torch.float64:
        f32 = dtypes = (torch.float64,)
    _build.check_tensor(f"{name}: x", x, dtypes, dev, ndim=5)
    for nm, t in (("dt", dt), ("cum", cum)):
        _build.check_tensor(f"{name}: {nm}", t, f32, dev, ndim=4)
    for nm, t in (("B", B), ("C", C)):
        _build.check_tensor(f"{name}: {nm}", t, dtypes, dev, ndim=5)
    if C.dtype != B.dtype:
        raise TypeError(f"{name}: B is {B.dtype} and C {C.dtype}; the "
                        "kernel takes both f32 or both bf16")
    if B.dtype == torch.bfloat16 and x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: B and C in bf16 need x in bf16, not "
                        f"{x.dtype}")
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    if (dt.shape != (b, nc, c, h) or cum.shape != dt.shape
            or B.shape[:3] != (b, nc, c) or C.shape != B.shape):
        raise ValueError(f"{name}: x {tuple(x.shape)} needs dt and cum "
                         f"(b, nc, c, h) and B, C (b, nc, c, g, n); got "
                         f"{tuple(dt.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if min(b, nc, c, h, g) < 1 or h % g != 0:
        raise ValueError(f"{name}: need b, nc, c >= 1 and h ({h}) a "
                         f"multiple of g ({g})")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"{name}: head dim {p} and state {n}, kernel "
                         f"takes p <= {MAX_P} and n <= {MAX_N}")
    return b, nc, c, h, p, g, n


def _forward(x, dt, cum, B, C):
    """The checked forward: the kernel on CUDA tensors, the plain version
    on CPU ones."""
    name = "ssd_chunk"
    b, nc, c, h, p, g, n = _check(name, x, dt, cum, B, C)
    dev = x.device
    if dev.type == "cpu":
        ssd_chunk.plain_calls += 1
        return ssd_chunk_plain(x, dt, cum, B, C)
    fn = _build.c_entry("ssd_chunk", "ssd_chunk", _ARGTYPES)
    _build.require_cuda(name, dev)
    body = body_for(x, B, C)
    y = torch.empty(b, nc, c, h, p, dtype=torch.float32, device=dev)
    states = torch.empty(b, nc, h, p, n, dtype=torch.float32, device=dev)
    rc = fn(BODIES.index(body), _build.DTYPE_CODE[x.dtype],
            _build.DTYPE_CODE[B.dtype], x.data_ptr(), dt.data_ptr(),
            cum.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            states.data_ptr(), b * nc, c, h, g, p, n,
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    ssd_chunk.launches += 1
    ssd_chunk.body_launches[body] += 1
    return y, states


def ssd_chunk(x, dt, cum, B, C):
    """K5: x (b, nc, c, h, p) f32/bf16; dt, cum (b, nc, c, h) f32; B, C
    (b, nc, c, g, n), both f32 or both bf16 (bf16 only with x bf16),
    h % g == 0, p <= 64, n <= 256. Returns (y_diag (b, nc, c, h, p),
    states (b, nc, h, p, n)), both f32. When grad mode is on and an
    input requires a gradient, the call goes through `SSDChunk`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, cum, B, C)):
        return SSDChunk.apply(x, dt, cum, B, C)
    return _forward(x, dt, cum, B, C)


ssd_chunk.launches = 0
ssd_chunk.body_launches = dict.fromkeys(BODIES, 0)
ssd_chunk.plain_calls = 0


def ssd_chunk_backward_plain(x, dt, cum, B, C, dy=None, dS=None):
    """Plain backward: (dx, ddt, dcum, dB, dC) by autograd through
    `ssd_chunk_plain` (what ``jax.grad`` of the JAX package's
    ``ssd_chunked`` computes for the intra-chunk block), each in its
    input's dtype; dy or dS None counts as zero."""
    ins = [t.detach().requires_grad_() for t in (x, dt, cum, B, C)]
    with torch.enable_grad():
        y, S = ssd_chunk_plain(*ins)
        outs = [(o, g) for o, g in ((y, dy), (S, dS)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    ins, [g for _, g in outs],
                                    allow_unused=True) if outs else \
            (None,) * 5
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(ins, grads))


def ssd_chunk_backward(x, dt, cum, B, C, dy=None, dS=None):
    """The gradient of `ssd_chunk` at (x, dt, cum, B, C) for dy (b, nc,
    c, h, p) and dS (b, nc, h, p, n), both f32 and contiguous (None:
    zero). Returns (dx in x's dtype, ddt (b, nc, c, h) f32, dcum f32, dB
    and dC (b, nc, c, g, n) in B's dtype, each summed over the heads of
    its group). On CPU tensors: the plain backward."""
    name = "ssd_chunk_backward"
    b, nc, c, h, p, g, n = _check(name, x, dt, cum, B, C)
    dev = x.device
    f32 = (torch.float32,)
    if dy is None:
        dy = torch.zeros(b, nc, c, h, p, dtype=torch.float32, device=dev)
    if dS is None:
        dS = torch.zeros(b, nc, h, p, n, dtype=torch.float32, device=dev)
    _build.check_tensor(f"{name}: dy", dy, f32, dev, ndim=5)
    _build.check_tensor(f"{name}: dS", dS, f32, dev, ndim=5)
    if dy.shape != x.shape or dS.shape != (b, nc, h, p, n):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must be x's shape "
                         f"and dS {tuple(dS.shape)} (b, nc, h, p, n) = "
                         f"{(b, nc, h, p, n)}")
    if dev.type == "cpu":
        ssd_chunk_backward.plain_calls += 1
        return ssd_chunk_backward_plain(x, dt, cum, B, C, dy, dS)
    fn = _build.c_entry("ssd_chunk_bwd", "ssd_chunk_backward",
                        _BWD_ARGTYPES)
    _build.require_cuda(name, dev)
    body = body_for(x, B, C)
    dx = torch.empty_like(x)
    ddt, dcum = torch.empty_like(dt), torch.empty_like(cum)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    scratch = torch.empty(_bwd_scratch_floats(body, b * nc, c, h, g, n),
                          dtype=torch.float32, device=dev)
    rc = fn(BODIES.index(body), _build.DTYPE_CODE[x.dtype],
            _build.DTYPE_CODE[B.dtype],
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dS.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dcum.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), b * nc, c, h, g, p, n,
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    ssd_chunk_backward.launches += 1
    ssd_chunk_backward.body_launches[body] += 1
    return dx, ddt, dcum, dB, dC


ssd_chunk_backward.launches = 0
ssd_chunk_backward.body_launches = dict.fromkeys(BODIES, 0)
ssd_chunk_backward.plain_calls = 0


class SSDChunk(torch.autograd.Function):
    """K5 with its gradient: the forward kernel and
    `ssd_chunk_backward`. Saves the five inputs."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C):
        y, states = _forward(x, dt, cum, B, C)
        ctx.save_for_backward(x, dt, cum, B, C)
        ctx.set_materialize_grads(False)
        return y, states

    @staticmethod
    def backward(ctx, dy, dS):
        return ssd_chunk_backward(
            *ctx.saved_tensors, None if dy is None else dy.contiguous(),
            None if dS is None else dS.contiguous())

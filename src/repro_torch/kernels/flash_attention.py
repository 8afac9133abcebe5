"""Flash attention for prefill (K2): the CUDA kernel's wrapper and its
plain PyTorch version.

Port of the TPU kernel `repro.kernels.flash_attention.flash_attention`
(Pallas): causal or bidirectional attention with an online softmax,
grouped-query (q head h reads kv head h // G), f32 accumulation, the
output in q's dtype. In bf16 the kernel runs on the tensor cores
(wgmma, its tiles brought in by TMA) and rounds the softmax weights to
bf16 for the value product, one rounding the plain version (all f32)
does not make. The causal mask compares absolute indices from 0 (q row
i sees positions j <= i), as the TPU kernel's does. With ``window=W``
(causal only) row i sees only positions ``i - W <= j <= i``, W + 1 of
them: the JAX package's
sliding window (``(aq - ak) <= window`` in
`repro.models.layers.chunked_attention`), which the hybrid family's
prefill past its cache takes; the kernel skips the tiles wholly before a
block's band. v may have its own head dim (`HEAD_DIM_PAIRS`): DeepSeek-V3's
MLA prefill attends with q/k heads of 192 and v heads of 128, as the JAX
package's `chunked_attention` lets it; that pair takes no window and has
no backward. The kernel is ``csrc/flash_attention.cu``; see its header
for the bound and the design.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``, and in ``window_launches`` too when it has a
window, in ``value_dim_launches`` when Dv != D) or raises. There is no
fallback from a failed build or launch to the plain version.

Training: when q, k or v requires a gradient (and grad mode is on),
`flash_attention` runs through `FlashAttention`, a
``torch.autograd.Function``: its forward asks the kernel for each row's
log-sum-exp as well, and its backward is `flash_attention_backward`, the
hand-written backward kernel (``csrc/flash_attention_bwd.cu``; counted in
its own ``launches``), which takes head dims `BWD_HEAD_DIMS`. In bf16 it
runs on the tensor cores (wgmma, TMA) and rounds the softmax weights P
and their gradients dS to bf16 for the products that contract over a
row or a key, roundings the plain backward does not make
(`backward_round_terms` bounds them); in f32 it runs on the CUDA cores.
On CPU tensors both take their plain versions: the forward
`flash_attention_plain` and the backward `flash_attention_backward_plain`
(autograd through the plain forward; counted in ``plain_calls``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128)
# the (q/k, v) head dims the forward kernel takes: (D, D) for D in
# HEAD_DIMS, and MLA's (192, 128) (DeepSeek-V3: 128 decompressed + 64
# rotary dims a q/k head, 128 a v head)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
# the backward kernel's head dims (80: the hybrid family's shared block)
BWD_HEAD_DIMS = (32, 64, 80, 128)
_BWD_PAIRS = tuple((d, d) for d in BWD_HEAD_DIMS)
DTYPES = tuple(_build.DTYPE_CODE)
_P = _build.PTR
_I = ctypes.c_int
# dtype, q, k, v, out, B, S, T, H, KVH, D, Dv, scale, causal, window, lse,
# stream
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _I, _P, _P]
# dtype, q, k, v, o, do, lse, delta, dq, dk, dv, B, S, T, H, KVH, D, scale,
# causal, stream
_BWD_ARGTYPES = ([_I] + [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _P])


def band_mask(S: int, T: int, window, device):
    """(S, T) bool, True where key j is visible to query i under the
    causal mask and the sliding window ``window`` (None: causal only):
    ``j <= i`` and ``i - j <= window``, the JAX package's mask."""
    pos_q = torch.arange(S, device=device)[:, None]
    pos_k = torch.arange(T, device=device)[None, :]
    ok = pos_q >= pos_k
    if window is not None:
        ok &= (pos_q - pos_k) <= window
    return ok


def _check_window(name, causal, window):
    if window is None:
        return
    if not causal:
        raise ValueError(f"{name}: a window needs causal=True")
    if isinstance(window, bool) or not isinstance(window, int) \
            or window < 0:
        raise ValueError(f"{name}: window {window!r} must be an int >= 0")


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None,
                          window=None):
    """Plain version (`repro.kernels.ref.flash_attention_ref`, with the
    kernel's ``* scale``; ``window`` as `band_mask`). v may have its own
    head dim (the output's), as in `repro.models.layers.chunked_attention`;
    the scale defaults to 1/sqrt(q's head dim)."""
    _check_window("flash_attention_plain", causal, window)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale or 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(g, dim=2).to(torch.float32)
    vf = v.repeat_interleave(g, dim=2).to(torch.float32)
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kf) * scale
    if causal:
        s = s.masked_fill(~band_mask(S, T, window, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def _check(name, q, k, v, pairs=HEAD_DIM_PAIRS):
    """Raise on anything the kernels do not take (``pairs``: the (q/k, v)
    head dims they take); returns (B, S, T, H, KVH, D)."""
    dev = q.device
    _build.check_tensor(f"{name}: q", q, DTYPES, dev, ndim=4)
    for nm, x in (("k", k), ("v", v)):
        _build.check_tensor(f"{name}: {nm}", x, (q.dtype,), dev, ndim=4)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if (v.shape[:3] != k.shape[:3] or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"{name}: k {tuple(k.shape)} must be (B={B}, T, "
                         f"KVH, D={D}) and v {tuple(v.shape)} (B, T, KVH, "
                         "Dv)")
    if min(B, S, T, KVH) < 1 or H % KVH != 0:
        raise ValueError(f"{name}: need B, S, T >= 1 and H ({H}) a "
                         f"multiple of KVH ({KVH})")
    if (D, v.shape[3]) not in pairs:
        raise ValueError(f"{name}: head dim {D} (v {v.shape[3]}), kernel "
                         f"takes (q/k, v) {pairs}")
    return B, S, T, H, KVH, D


def _forward(q, k, v, causal, scale, with_lse, window=None):
    """The checked forward: (out, lse) with lse (B, H, S) f32 from the
    kernel when ``with_lse`` on CUDA, else None."""
    name = "flash_attention"
    B, S, T, H, KVH, D = _check(name, q, k, v)
    Dv = v.shape[3]
    _check_window(name, causal, window)
    if window is not None and Dv != D:
        raise ValueError(f"{name}: a window needs v's head dim ({Dv}) equal "
                         f"to q's ({D}) (no JAX path windows MLA)")
    scale = scale or 1.0 / math.sqrt(D)
    dev = q.device
    if dev.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window), None
    fn = _build.c_entry("flash_attention", "flash_attention", _ARGTYPES)
    _build.require_cuda(name, dev)
    # the bf16 kernel's TMA tensor maps need 16-byte aligned addresses
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start at 16-byte "
                         "aligned addresses")
    out = torch.empty(B, S, H, Dv, dtype=q.dtype, device=dev)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=dev)
           if with_lse else None)
    rc = fn(_build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, T, H, KVH, D, Dv,
            float(scale), int(causal), -1 if window is None else window,
            0 if lse is None else lse.data_ptr(),
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    flash_attention.launches += 1
    flash_attention.window_launches += window is not None
    flash_attention.value_dim_launches += Dv != D
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    window=None):
    """q (B, S, H, D); k (B, T, KVH, D), v (B, T, KVH, Dv) -> (B, S, H,
    Dv). H % KVH == 0, (D, Dv) in HEAD_DIM_PAIRS; f32 or bf16, one dtype
    for all three; ``window`` an int >= 0 (causal only: row i sees keys i
    - window..i; Dv = D only) or None. When grad mode is on and q, k or v
    requires a gradient, the call goes through `FlashAttention` (the
    kernel then also writes the log-sum-exp that its backward reads; Dv
    = D in BWD_HEAD_DIMS, else ValueError); no path of the JAX package
    trains with a window, so that raises."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if window is not None:
            raise ValueError("flash_attention: a window has no backward "
                             "kernel (no JAX path trains with one)")
        return FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, False, window)[0]


flash_attention.launches = 0
# of those launches, the ones with a window, and the ones whose v has a
# head dim of its own (MLA's (192, 128))
flash_attention.window_launches = 0
flash_attention.value_dim_launches = 0
flash_attention.plain_calls = 0


def flash_attention_backward_plain(q, k, v, do, *, causal: bool = True,
                                   scale=None):
    """Plain backward: (dq, dk, dv) by autograd through
    `flash_attention_plain` (what ``jax.grad`` of the JAX model's
    attention computes), each in its input's dtype."""
    with torch.enable_grad():
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        out = flash_attention_plain(qr, kr, vr, causal=causal, scale=scale)
        return torch.autograd.grad(out, (qr, kr, vr), do)


def backward_o_terms(q, k, v, o, do, *, causal: bool = True, scale=None):
    """How far the backward may move per unit of relative error in the
    forward's output ``o`` (its rounding to bf16), in f32: the kernel
    forms Dl_i = sum_d do_id o_id from ``o``, so an error of e |o| there
    moves Dl_i by at most e A_i, A_i = sum_d |do_id| |o_id|, and dS_ij by
    P_ij e A_i. Returns (dq, dk, dv) terms: scale A_i sum_j P_ij |k_j|,
    scale sum_i P_ij A_i |q_i| (summed over the group) and 0; the limits
    in chip_smoke.py and the card tests add o_round times these. Plain
    PyTorch (it forms P (B, H, S, T))."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale or 1.0 / math.sqrt(D)
    qf, kf, of, dof = (x.to(torch.float32) for x in (q, k, o, do))
    kr = kf.repeat_interleave(g, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kr) * scale
    if causal:
        pos_q = torch.arange(S, device=q.device)
        pos_k = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos_q[:, None] >= pos_k[None, :]),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    a = (dof.abs() * of.abs()).sum(-1)                    # (B, S, H)
    t_dq = scale * a[..., None] * torch.einsum("bhst,bthd->bshd", p,
                                                kr.abs())
    t_dk = scale * torch.einsum("bhst,bshd->bthd", p,
                                a[..., None] * qf.abs())
    t_dk = t_dk.reshape(B, T, KVH, g, D).sum(3)
    return t_dq, t_dk, torch.zeros_like(t_dk)


def backward_round_terms(q, k, v, do, *, causal: bool = True, scale=None):
    """How far the bf16 backward kernel's roundings of P and dS may move
    each output, per unit of relative rounding error, in f32: the kernel
    rounds each weight P_ij to bf16 for dv_j = sum_i P_ij do_i, and each
    dS_ij = P_ij (do_i . v_j - Dl_i) to bf16 for dk_j = scale sum_i dS_ij
    q_i and dq_i = scale sum_j dS_ij k_j, each a relative error of at most
    2^-8 (the weight's in the forward: its ``p_round``). Returns (dq, dk,
    dv) terms: scale sum_j |dS_ij| |k_j|, scale sum_i |dS_ij| |q_i| and
    sum_i P_ij |do_i| (dk and dv summed over the group's heads); the limits
    in chip_smoke.py and the card tests add p_round times these. Plain
    PyTorch (it forms P and dS (B, H, S, T))."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale or 1.0 / math.sqrt(D)
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    kr = k.to(torch.float32).repeat_interleave(g, dim=2)
    vr = v.to(torch.float32).repeat_interleave(g, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kr) * scale
    if causal:
        pos_q = torch.arange(S, device=q.device)
        pos_k = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos_q[:, None] >= pos_k[None, :]),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bhst,bthd->bshd", p, vr)
    dl = (dof * o).sum(-1).transpose(1, 2)                # (B, H, S)
    ds = (p * (torch.einsum("bshd,bthd->bhst", dof, vr)
               - dl[..., None])).abs()
    t_dq = scale * torch.einsum("bhst,bthd->bshd", ds, kr.abs())
    t_dk = scale * torch.einsum("bhst,bshd->bthd", ds, qf.abs())
    t_dv = torch.einsum("bhst,bshd->bthd", p, dof.abs())
    return (t_dq, t_dk.reshape(B, T, KVH, g, D).sum(3),
            t_dv.reshape(B, T, KVH, g, D).sum(3))


def flash_attention_backward(q, k, v, o, do, lse, *, causal: bool = True,
                             scale=None):
    """The gradient of `flash_attention` at (q, k, v), its output ``o``
    and log-sum-exp ``lse`` (B, H, S) f32 from the forward, for the
    output's gradient ``do`` (B, S, H, D): (dq, dk, dv) in q's dtype, D
    in BWD_HEAD_DIMS. On CPU tensors: the plain backward (``o`` and
    ``lse`` unused, may be None)."""
    name = "flash_attention_backward"
    B, S, T, H, KVH, D = _check(name, q, k, v, _BWD_PAIRS)
    dev = q.device
    _build.check_tensor(f"{name}: do", do, (q.dtype,), dev, ndim=4)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    scale = scale or 1.0 / math.sqrt(D)
    if dev.type == "cpu":
        flash_attention_backward.plain_calls += 1
        return flash_attention_backward_plain(q, k, v, do, causal=causal,
                                              scale=scale)
    _build.check_tensor(f"{name}: o", o, (q.dtype,), dev, ndim=4)
    _build.check_tensor(f"{name}: lse", lse, (torch.float32,), dev, ndim=3)
    if o.shape != q.shape or tuple(lse.shape) != (B, H, S):
        raise ValueError(f"{name}: o {tuple(o.shape)} must be q's shape and "
                         f"lse {tuple(lse.shape)} (B, H, S) = {(B, H, S)}")
    fn = _build.c_entry("flash_attention_bwd", "flash_attention_backward",
                        _BWD_ARGTYPES)
    _build.require_cuda(name, dev)
    # the bf16 kernel's TMA tensor maps need 16-byte aligned addresses
    if any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError(f"{name}: q, k, v, o and do must start at 16-byte "
                         "aligned addresses")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # scratch: the rows' lse and Dl, padded to whole blocks of 128 rows
    s_rows = -(-S // 128) * 128
    delta = torch.empty(2 * B * H * s_rows, dtype=torch.float32,
                        device=dev)
    rc = fn(_build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, T, H, KVH, D, float(scale), int(causal),
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.plain_calls = 0


class FlashAttention(torch.autograd.Function):
    """K2 with its gradient: the forward kernel (with the log-sum-exp on
    CUDA) and `flash_attention_backward`. Saves q, k, v, the output and
    the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        _check("flash_attention", q, k, v, _BWD_PAIRS)
        out, lse = _forward(q, k, v, causal, scale, q.device.type != "cpu")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, do.contiguous(), lse, causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None

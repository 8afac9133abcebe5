"""Mamba2 (state-space duality) block of the port (counterpart of
`repro.models.mamba`).

Prefill uses the chunked block decomposition of Dao & Gu 2024
(arXiv:2405.21060): the intra-chunk quadratic block, computed by K5
(`kernels.ssd_chunk`), plus the inter-chunk state recurrence, a plain
Python loop over the chunks (O(L / chunk) small steps, latency-bound,
as the JAX package's ``lax.scan``). Decode is the O(1) per-token
recurrence on the (heads, headdim, state) SSM state, plain PyTorch.
The gate norm is K4a (`kernels.rmsnorm`).

Training (`Model.loss`): a layer's forward takes a dict of its tensors
(`layers.at`), and K5 and K4a run through their autograd Functions, so
that the intra-chunk block's gradient is K5's backward kernel
(`kernels.ssd_chunk.ssd_chunk_backward`); the gradient of the chunk
sums (``torch.cumsum``), of the inter-chunk loop, the conv and the
projections is plain autograd, as ``jax.grad`` differentiates them in
the JAX package.

`Mamba` holds the block's parameters stacked on a leading layer axis,
with the JAX package's names, layouts and init distributions
(`repro.models.mamba.init_mamba`), so that `convert.from_jax_params`
maps one leaf to one tensor. ``ssd_reference`` (token-by-token
recurrence) is the oracle of the tests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models.layers import at, init_normal_, rms_norm, stacked


def _depthwise_causal_conv(x, w, b, state=None):
    """x (B, L, C), w (K, C) depthwise causal, b (C,); optional carry-in
    state (B, K-1, C). Returns (silu(conv + b), new_state), new_state the
    last K-1 inputs. The sum of K shifted products, as the JAX package
    writes it (no cuDNN convolution, which runs f32 in TF32)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], K - 1, x.shape[-1], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return F.silu(y + b), new_state


def ssd_chunked(x, dt, A, B, C, *, chunk: int, init_state=None):
    """Chunked SSD.

    x:  (b, l, h, p)    values
    dt: (b, l, h)       softplus-activated step sizes (> 0)
    A:  (h,)            negative decay rates
    B, C: (b, l, g, n)  input/output projections (g groups)
    init_state: (b, h, p, n) or None.
    Returns (y (b, l, h, p) in x's dtype, final_state (b, h, p, n) f32).
    The length is padded to a multiple of ``chunk`` with zeros (dt = 0
    there, so the padded steps leave the state as it is). x, B and C go
    to K5 in their own dtype (it widens them exactly: bf16 ones take its
    tensor-core body); dt and everything after K5 is f32. f64 inputs on
    the CPU (a reference precision) run in f64 throughout, the final
    state too.
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"ssd_chunked: {h} heads, not a multiple of {g} "
                         "groups")
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // chunk
    hg = h // g
    # the working float: f32, or f64 for an f64 reference on the CPU
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32

    xc = x.reshape(b, nc, chunk, h, p).contiguous()
    dtc = dt.reshape(b, nc, chunk, h).to(f32).contiguous()
    Bc = B.reshape(b, nc, chunk, g, n).contiguous()
    Cc = C.reshape(b, nc, chunk, g, n).contiguous()

    dA = dtc * A.to(f32)                       # (b, nc, c, h) <= 0
    cum = torch.cumsum(dA, dim=2)              # within-chunk cumsum
    total = cum[:, :, -1]                      # (b, nc, h)

    # intra-chunk block and chunk states: K5
    y_diag, dBx = ssd_chunk(xc, dtc, cum, Bc, Cc)

    # inter-chunk recurrence over nc: the state before each chunk
    S = (torch.zeros(b, h, p, n, dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    decay = torch.exp(total)                   # (b, nc, h)
    S_prev = []
    for ci in range(nc):
        S_prev.append(S)
        S = S * decay[:, ci, :, None, None] + dBx[:, ci]
    S_prev = torch.stack(S_prev, dim=1)        # (b, nc, h, p, n)

    # inter-chunk contribution: y[s] += exp(cum[s]) * C[s] . S_prev,
    # contracted per group (no copy of C over the heads), in f32
    y_off = torch.einsum("bcsgn,bcgjpn->bcsgjp", Cc.to(f32),
                         S_prev.view(b, nc, g, hg, p, n))
    y_off = y_off * torch.exp(cum).view(b, nc, chunk, g, hg, 1)
    y = (y_diag + y_off.reshape(b, nc, chunk, h, p)).reshape(
        b, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), S


def ssd_reference(x, dt, A, B, C, init_state=None):
    """Token-by-token recurrence oracle (slow, exact)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    f32 = torch.float32
    S = (torch.zeros(b, h, p, n, dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t].to(f32) * A)                 # (b, h)
        Bh = B[:, t].to(f32).repeat_interleave(hg, dim=1)    # (b, h, n)
        Ch = C[:, t].to(f32).repeat_interleave(hg, dim=1)
        S = S * dA[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t].to(f32), x[:, t].to(f32), Bh)
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch))
    return torch.stack(ys, dim=1).to(x.dtype), S


class Mamba(nn.Module):
    """The Mamba2 mixers of ``n_layers`` layers, leaves stacked on a
    leading layer axis."""

    def __init__(self, cfg, n_layers: int, device):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
        kw = dict(dtype=cfg.pdtype, device=device)
        self.w_xz = stacked(n_layers, d, 2 * di, **kw)
        self.w_bc = stacked(n_layers, d, 2 * g * n, **kw)
        self.w_dt = stacked(n_layers, d, h, **kw)
        self.dt_bias = stacked(n_layers, h, **kw)
        self.A_log = stacked(n_layers, h, **kw)
        self.D = stacked(n_layers, h, **kw)
        self.conv_w = stacked(n_layers, cfg.ssm_conv, di + 2 * g * n, **kw)
        self.conv_b = stacked(n_layers, di + 2 * g * n, **kw)
        self.gate_norm = stacked(n_layers, di, **kw)
        self.w_out = stacked(n_layers, di, d, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX init: normal x 1/sqrt(fan-in) (a layer's leading
        dim), ``dt_bias`` and ``conv_b`` zeros, ``A_log``, ``D`` and
        ``gate_norm`` ones."""
        for p in (self.w_xz, self.w_bc, self.w_dt, self.conv_w, self.w_out):
            init_normal_(p, gen, 1.0 / math.sqrt(p.shape[1]))
        self.dt_bias.zero_()
        self.conv_b.zero_()
        for p in (self.A_log, self.D, self.gate_norm):
            p.fill_(1.0)

    def _in_proj(self, l, x, conv_state):
        """The projections, dt and the causal conv of x (B, L, d), for
        layer ``l`` (its index, or a dict of its tensors: `layers.at`):
        (xh (B, L, h, p), z, dt (B, L, h) f32, B, C (B, L, g, n), new
        conv state)."""
        cfg = self.cfg
        di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, \
            cfg.ssm_heads
        Bsz, L = x.shape[:2]
        xz = x @ at(self, "w_xz", l)
        xin, z = xz[..., :di], xz[..., di:]
        bc = x @ at(self, "w_bc", l)
        dt = F.softplus((x @ at(self, "w_dt", l)).to(torch.float32)
                        + at(self, "dt_bias", l).to(torch.float32))
        conv_out, new_conv = _depthwise_causal_conv(
            torch.cat([xin, bc], dim=-1), at(self, "conv_w", l),
            at(self, "conv_b", l), conv_state)
        xh = conv_out[..., :di].reshape(Bsz, L, h, cfg.ssm_headdim)
        Bm = conv_out[..., di:di + g * n].reshape(Bsz, L, g, n)
        Cm = conv_out[..., di + g * n:].reshape(Bsz, L, g, n)
        return xh, z, dt, Bm, Cm, new_conv

    def _out_proj(self, l, y, z):
        """The gate norm (K4a) of y * silu(z), then the out projection."""
        y = rms_norm((y * F.silu(z)).contiguous(), at(self, "gate_norm", l),
                     self.cfg.norm_eps)
        return y @ at(self, "w_out", l)

    def forward(self, l, x, conv_state=None, ssm_state=None):
        """Full-sequence block ``l`` (an index, or a dict of the layer's
        tensors: a training forward) over x (B, L, d). Returns (out, (new
        conv state (B, K-1, C), final SSM state (B, h, p, n) f32))."""
        cfg = self.cfg
        xh, z, dt, Bm, Cm, new_conv = self._in_proj(l, x, conv_state)
        A = -torch.exp(at(self, "A_log", l).to(torch.float32))
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                               init_state=ssm_state)
        y = y + xh * at(self, "D", l).to(y.dtype)[:, None]
        y = y.reshape(*x.shape[:2], cfg.d_inner)
        return self._out_proj(l, y, z), (new_conv, final)

    def decode(self, l: int, x, conv_state, ssm_state):
        """One token of block ``l``: x (B, 1, d). Returns (out, (new conv
        state, new SSM state))."""
        cfg = self.cfg
        hg = cfg.ssm_heads // cfg.ssm_ngroups
        f32 = torch.float32
        xh, z, dt, Bm, Cm, new_conv = self._in_proj(l, x, conv_state)
        xh, dt = xh[:, 0], dt[:, 0]                      # (B,h,p), (B,h)
        A = -torch.exp(at(self, "A_log", l).to(f32))
        dA = torch.exp(dt * A)                           # (B, h)
        Bh = Bm[:, 0].repeat_interleave(hg, dim=1).to(f32)
        Ch = Cm[:, 0].repeat_interleave(hg, dim=1).to(f32)
        S = ssm_state * dA[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt, xh.to(f32), Bh)
        y = torch.einsum("bhpn,bhn->bhp", S, Ch)
        y = y + xh.to(f32) * at(self, "D", l).to(f32)[:, None]
        y = y.reshape(-1, 1, cfg.d_inner).to(x.dtype)
        return self._out_proj(l, y, z), (new_conv, S)

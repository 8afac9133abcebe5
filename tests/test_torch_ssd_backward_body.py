"""K5's backward on the CPU: the wrapper's choice of body, and the
arithmetic of the tensor-core body held to the plain backward.

(a) `body_for`, the choice of body in both directions, sends x, B and C in bf16 at p = 64, n a multiple of
64 up to 256, c <= 256 and 16-byte aligned starts to the "wgmma" body,
everything else (f32 inputs, bf16 x with f32 B and C, other widths,
longer chunks, misaligned views) to the "cuda_core" body.

(b) `emulate_wgmma_backward` repeats, in PyTorch on the CPU, what the
wgmma body of ``csrc/ssd_chunk_bwd.cu`` computes and in which pieces:
dy and dS split into three bf16 parts by the split pass; 64-row tiles
of positions t; each tile's scores B C^T formed from exact bf16
products; the f32 weights split into three bf16 parts, dx = M^T dy with
the six kept cross terms of M's and dy's parts; G = dM L dt summed over
a slice of heads (at most `SLICE_HEADS`) before its three parts meet B
or C; the state terms against dS's parts; the finisher's sums of ddt
and dcum. Every product takes bf16 operands (exact in f32) and sums in
f32. At c = 256, p = 64, n = 64 with two heads a group it is held to
`ssd_chunk_backward_plain` within the card tests' SSD_BWD_TOL,
unchanged; a one-part split of dy (no mid and lo parts) must miss it,
and so must the plain backward without one causal tile pair.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_chunk as K5
from test_torch_cuda import SSD_BWD_TOL, _ssd_bwd_use, _ssd_fault_plain

BF, F32 = torch.bfloat16, torch.float32
TILE = 64
# the cross terms of the weights' parts (0 hi, 1 mid, 2 lo) and dy's
# that dx keeps: every pair whose orders add to at most 2
DX_TERMS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _inputs(b, nc, c, h, p, n, g, xdtype, bcdtype, seed=0):
    r = np.random.default_rng(seed)
    L = nc * c
    x = r.normal(size=(b, nc, c, h, p))
    dt = r.uniform(0.01, 0.2, (b, nc, c, h))
    A = -r.uniform(0.5, 2.0, (h,))
    B, C = r.normal(size=(2, b, L, g, n))
    mk = lambda a, d=F32: torch.tensor(a, dtype=d)  # noqa: E731
    return (mk(x, xdtype), mk(dt), mk(np.cumsum(dt * A, axis=2)),
            mk(B.reshape(b, nc, c, g, n), bcdtype),
            mk(C.reshape(b, nc, c, g, n), bcdtype))


# --------------------------------------------------------- (a) the choice
@pytest.mark.parametrize("xd,bcd,p,n,c,want", [
    (BF, BF, 64, 128, 256, "wgmma"),        # Mamba2-780M's training shape
    (BF, BF, 64, 64, 256, "wgmma"),         # Zamba2-2.7B's
    (BF, BF, 64, 256, 256, "wgmma"),
    (BF, BF, 64, 192, 100, "wgmma"),
    (BF, BF, 64, 64, 1, "wgmma"),
    (BF, BF, 64, 128, 257, "cuda_core"),    # c > 256
    (BF, BF, 32, 128, 256, "cuda_core"),    # p != 64
    (BF, BF, 64, 96, 256, "cuda_core"),     # n not a multiple of 64
    (BF, BF, 16, 16, 32, "cuda_core"),      # the smoke configs
    (BF, F32, 64, 128, 256, "cuda_core"),   # bf16 x, f32 B and C
    (F32, F32, 64, 128, 256, "cuda_core"),  # the f32 training
])
def test_body_for_shape_classes_of_the_backward(xd, bcd, p, n, c, want):
    x, dt, cum, B, C = _inputs(1, 1, c, 2, p, n, 1, xd, bcd)
    assert K5.body_for(x, B, C) == want


@pytest.mark.parametrize("which", ["x", "B", "C"])
def test_body_for_misaligned_view_takes_cuda_core(which):
    """A view that starts 2 bytes past a 16-byte boundary (the tensor
    maps need 16) takes the CUDA-core body; its aligned twin the wgmma
    body."""
    x, dt, cum, B, C = _inputs(1, 1, 64, 2, 64, 64, 1, BF, BF)
    ins = dict(x=x, B=B, C=C)
    t = ins[which]
    flat = torch.zeros(t.numel() + 8, dtype=BF)
    flat[1:1 + t.numel()] = t.reshape(-1)
    ins[which] = flat[1:1 + t.numel()].view(t.shape)
    assert ins[which].data_ptr() % 16 != 0
    assert K5.body_for(ins["x"], ins["B"], ins["C"]) == "cuda_core"
    ins[which] = flat[8:8 + t.numel()].view(t.shape)
    assert ins[which].data_ptr() % 16 == 0
    assert K5.body_for(ins["x"], ins["B"], ins["C"]) == "wgmma"


def test_bwd_body_names_match_the_entry():
    assert K5.BODIES == ("cuda_core", "wgmma")
    assert set(K5.ssd_chunk_backward.body_launches) == set(K5.BODIES)


# ------------------------------------------------ (b) the body's arithmetic
def split3(v):
    """v (f32) as three bf16 parts, each rounded to nearest: hi, mid, lo
    (returned widened to f32; hi + mid + lo carries ~24 bits of v)."""
    hi = v.to(BF).float()
    r = v - hi
    mid = r.to(BF).float()
    return hi, mid, (r - mid).to(BF).float()


def _pad(t, dim, size):
    """Zero rows past the end along ``dim`` up to ``size`` (the tensor
    maps' zero fill past c)."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def emulate_wgmma_backward(x, dt, cum, B, C, dy, dS, dy_parts=3,
                           slice_heads=None):
    """The wgmma body's dataflow and arithmetic on CPU tensors; returns
    (dx in x's dtype, ddt, dcum f32, dB and dC in B's dtype), as
    `ssd_chunk_backward`. ``dy_parts`` < 3 keeps only the first parts of
    dy's split (a negative control)."""
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    hg = h // g
    hs = slice_heads or K5.SLICE_HEADS
    nt = -(-c // TILE)
    cp = nt * TILE
    # the split pass (dy, dS -> three bf16 parts each), and the tiles'
    # zero fill past c; positions on dim 2
    dy3 = [_pad(d, 2, cp) for d in split3(dy)][:dy_parts]
    dS3 = split3(dS)
    xf = _pad(x.float(), 2, cp)
    Bf, Cf = _pad(B.float(), 2, cp), _pad(C.float(), 2, cp)
    cumv = cum.transpose(2, 3)                       # (b, nc, h, c)
    dtv = dt.transpose(2, 3)
    total = cumv[..., c - 1:c]
    ew = torch.exp(total - cumv)
    w = ew * dtv
    pos = torch.arange(cp)
    cum_p = _pad(cumv, 3, cp)
    dt_p = _pad(dtv, 3, cp)

    def rows(t, i):
        return t[:, :, i * TILE:(i + 1) * TILE]

    def weights_l(i, j):
        """L (b, nc, h, 64 t of tile j, 64 s of tile i), masked (t <= s
        < c) before the exponent."""
        t = pos[j * TILE:(j + 1) * TILE, None]
        s = pos[None, i * TILE:(i + 1) * TILE]
        keep = (t <= s) & (s < c)
        diff = (cum_p[..., None, i * TILE:(i + 1) * TILE]
                - cum_p[..., j * TILE:(j + 1) * TILE, None])
        return torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)),
                           0.0)

    grp_of = torch.arange(h) // hg
    dx = torch.zeros(b, nc, cp, h, p)
    dw = torch.zeros(b, nc, h, cp)
    q = torch.zeros(b, nc, h, cp)
    row_r = torch.zeros(nt, b, nc, h, cp)
    # the G blocks' scratch: G summed over a slice, (s, t) a slice
    n_sl = -(-hg // hs)
    gsum = torch.zeros(b, nc, g, n_sl, cp, cp)
    dbst = torch.zeros(b, nc, g, n_sl, cp, n)
    for j in range(nt):
        Bown = rows(Bf, j)[:, :, :, grp_of]          # (b,nc,64,h,n)
        xown = rows(xf, j)                           # (b,nc,64,h,p)
        dt_t = dt_p[..., j * TILE:(j + 1) * TILE, None]
        # ---- the dx blocks: a (tile, head) each
        u = sum(torch.einsum("bctha,bchda->bcthd", Bown, d) for d in dS3)
        dwj = (xown * u).sum(-1)                     # (b,nc,64,h)
        dw[..., j * TILE:(j + 1) * TILE] = dwj.transpose(2, 3)
        wj = _pad(w, 3, cp)[..., j * TILE:(j + 1) * TILE]
        acc = u * wj.transpose(2, 3)[..., None]
        for i in range(j, nt):
            Ci = rows(Cf, i)[:, :, :, grp_of]
            sc = torch.einsum("bctha,bcsha->bchts", Bown, Ci)
            m = sc * weights_l(i, j) * dt_t
            mp = split3(m)
            dyi = [rows(d, i) for d in dy3]
            for a, e in DX_TERMS:
                if e < len(dyi):
                    acc = acc + torch.einsum("bchts,bcshd->bcthd", mp[a],
                                             dyi[e])
        dx[:, :, j * TILE:(j + 1) * TILE] = acc
        # ---- the G blocks: a (tile, slice of heads) each
        for i in range(j, nt):
            Ci = rows(Cf, i)[:, :, :, grp_of]
            sc = torch.einsum("bctha,bcsha->bchts", Bown, Ci)
            dmt = sum(torch.einsum("bcthd,bcshd->bchts", xown, rows(d, i))
                      for d in dy3)
            lv = weights_l(i, j)
            qv = dmt * sc * lv
            q[..., j * TILE:(j + 1) * TILE] += qv.sum(-1)
            row_r[j, ..., i * TILE:(i + 1) * TILE] = (qv * dt_t).sum(-2)
            gh = (dmt * lv * dt_t).reshape(b, nc, g, hg, TILE, TILE)
            for sl in range(n_sl):
                part = gh[:, :, :, sl * hs:(sl + 1) * hs].sum(3)
                gsum[:, :, :, sl, i * TILE:(i + 1) * TILE,
                     j * TILE:(j + 1) * TILE] = part.transpose(-1, -2)
        z = sum(torch.einsum("bcthd,bchdk->bcthk", xown, d) for d in dS3)
        z = (z * wj.transpose(2, 3)[..., None]).reshape(b, nc, TILE, g, hg, n)
        for sl in range(n_sl):
            dbst[:, :, :, sl, j * TILE:(j + 1) * TILE] = (
                z[:, :, :, :, sl * hs:(sl + 1) * hs].sum(4)
                .transpose(2, 3))
    # ---- the group blocks: dC a tile of rows s, dB a tile of rows t
    G = gsum.sum(3)                                  # (b,nc,g,s,t)
    dC = torch.zeros(b, nc, g, cp, n)
    dB = dbst.sum(3)
    for j in range(nt):
        for i in range(j + 1):
            gp = split3(G[..., j * TILE:(j + 1) * TILE,
                          i * TILE:(i + 1) * TILE])
            Bi = rows(Bf, i).transpose(2, 3)         # (b,nc,g,64,n)
            dC[..., j * TILE:(j + 1) * TILE, :] += sum(pp @ Bi for pp in gp)
        for i in range(j, nt):
            gp = split3(G[..., i * TILE:(i + 1) * TILE,
                          j * TILE:(j + 1) * TILE].transpose(-1, -2))
            Ci = rows(Cf, i).transpose(2, 3)
            dB[..., j * TILE:(j + 1) * TILE, :] += sum(pp @ Ci for pp in gp)
    # ---- the finisher
    qc, dwc = q[..., :c], dw[..., :c]
    ddt = qc + dwc * ew
    tile_of = torch.arange(c) // TILE
    rr = sum(torch.where(tile_of >= i, row_r[i, ..., :c], 0.0)
             for i in range(nt))
    dcum = rr - dtv * qc - dwc * w
    dcum[..., c - 1] += (dwc * w).sum(-1)
    return (dx[:, :, :c].to(x.dtype), ddt.transpose(2, 3).contiguous(),
            dcum.transpose(2, 3).contiguous(),
            dB[..., :c, :].transpose(2, 3).to(B.dtype).contiguous(),
            dC[..., :c, :].transpose(2, 3).to(B.dtype).contiguous())


def _grads(b, nc, c, h, p, n, g, seed):
    args = _inputs(b, nc, c, h, p, n, g, BF, BF, seed)
    r = np.random.default_rng(seed + 1)
    dy = torch.tensor(r.normal(size=(b, nc, c, h, p)), dtype=F32)
    dS = torch.tensor(r.normal(size=(b, nc, h, p, n)), dtype=F32)
    return args, dy, dS


NAMES = ("dx", "ddt", "dcum", "dB", "dC")


@pytest.mark.parametrize("b,nc,c,h,p,n,g,slice_heads", [
    (1, 2, 256, 4, 64, 64, 2, None),     # two heads a group, one slice
    (1, 1, 256, 6, 64, 64, 2, 2),        # three heads a group, two slices
    (1, 1, 200, 4, 64, 128, 1, None),    # a ragged last tile, n 128
])
def test_emulated_wgmma_body_within_the_card_limit(b, nc, c, h, p, n, g,
                                                    slice_heads, capsys):
    args, dy, dS = _grads(b, nc, c, h, p, n, g, seed=c + h)
    got = emulate_wgmma_backward(*args, dy, dS, slice_heads=slice_heads)
    want = K5.ssd_chunk_backward_plain(*args, dy, dS)
    uses = [_ssd_bwd_use(a, w, SSD_BWD_TOL) for a, w in zip(got, want)]
    with capsys.disabled():
        print("\nemulated wgmma body, use of SSD_BWD_TOL:",
              dict(zip(NAMES, (round(u, 4) for u in uses))))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
    assert max(uses) <= 1.0, dict(zip(NAMES, uses))
    if c > 128:
        ins = [t.detach().float().requires_grad_() for t in args]
        with torch.enable_grad():
            fault = torch.autograd.grad(_ssd_fault_plain(*ins), ins,
                                        (dy, dS))
        assert max(_ssd_bwd_use(f.to(w.dtype), w, SSD_BWD_TOL)
                   for f, w in zip(fault, want)) > 1.0


def test_emulated_one_part_split_of_dy_misses_the_limit():
    """With dy in one bf16 part (no mid and lo), dM's error reaches
    ~2^-9 of its terms and the f32 outputs miss the limit: the three
    parts are needed."""
    args, dy, dS = _grads(1, 1, 256, 2, 64, 64, 1, seed=5)
    got = emulate_wgmma_backward(*args, dy, dS, dy_parts=1)
    want = K5.ssd_chunk_backward_plain(*args, dy, dS)
    uses = dict(zip(NAMES, (_ssd_bwd_use(a, w, SSD_BWD_TOL)
                            for a, w in zip(got, want))))
    assert max(uses["ddt"], uses["dcum"]) > 1.0, uses

"""K5, the SSD intra-chunk block, and the chunked SSD of the port against
the JAX package on the same inputs (made with numpy).

The port's wrapper takes B and C by group; the TPU entry
(`repro.kernels.ops.ssd_chunk`, here in interpret mode) takes them
repeated over the heads, so the JAX side gets ``jnp.repeat``'ed copies.
On CPU tensors the wrapper computes its plain version (a CUDA tensor
launches the kernel: `tests/test_torch_cuda.py`). Tolerances are the
JAX package's own: `tests/test_kernels.py`'s 3e-4 for the kernel,
`tests/test_layers.py`'s 2e-4 for the chunked SSD.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import mamba as JM
from repro_torch.kernels import ssd_chunk as K5
from repro_torch.models import mamba as M

KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def _chunk_inputs(rng, b, nc, c, h, p, n, g):
    """Inputs in the ranges of tests/test_kernels.py: dt in [0.01, 0.2],
    A in [-2, -0.5] (mild decay: every (s, t) term counts)."""
    x = rng.normal(size=(b, nc, c, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, nc, c, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    cum = np.cumsum(dt * A, axis=2).astype(np.float32)
    B = rng.normal(size=(b, nc, c, g, n)).astype(np.float32)
    C = rng.normal(size=(b, nc, c, g, n)).astype(np.float32)
    return x, dt, cum, B, C


@pytest.mark.parametrize("b,nc,c,h,p,n,g", [
    (1, 2, 32, 2, 16, 16, 1),
    (2, 4, 64, 4, 64, 128, 1),    # production-ish chunk
    (1, 1, 16, 8, 32, 64, 1),
    (1, 2, 48, 6, 16, 32, 2),     # two groups, three heads each
])
def test_ssd_chunk_plain_matches_tpu_kernel(b, nc, c, h, p, n, g):
    rng = np.random.default_rng(b * 1000 + c + g)
    x, dt, cum, B, C = _chunk_inputs(rng, b, nc, c, h, p, n, g)
    rep = h // g
    want_y, want_s = ops.ssd_chunk(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(cum),
        jnp.repeat(jnp.asarray(B), rep, axis=3),
        jnp.repeat(jnp.asarray(C), rep, axis=3), interpret=True)
    before = K5.ssd_chunk.plain_calls
    got_y, got_s = K5.ssd_chunk(*(torch.tensor(a) for a in
                                  (x, dt, cum, B, C)))
    assert K5.ssd_chunk.plain_calls == before + 1
    assert got_y.dtype == got_s.dtype == torch.float32
    assert got_y.shape == (b, nc, c, h, p)
    assert got_s.shape == (b, nc, h, p, n)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **KERNEL_TOL)


def test_ssd_chunk_reads_bf16_x_as_is():
    """x in bf16 is widened as it is read: the same result as its f32
    copy."""
    rng = np.random.default_rng(7)
    x, dt, cum, B, C = (torch.tensor(a) for a in
                        _chunk_inputs(rng, 1, 2, 32, 4, 16, 16, 1))
    xb = x.to(torch.bfloat16)
    y1, s1 = K5.ssd_chunk(xb, dt, cum, B, C)
    y2, s2 = K5.ssd_chunk(xb.float(), dt, cum, B, C)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("b,nc,c,h,p,n,g", [
    (1, 2, 32, 4, 16, 16, 1),     # smoke widths: the CUDA-core body
    (1, 2, 64, 4, 64, 64, 2),     # the wgmma body's shape class
])
def test_ssd_chunk_widens_bf16_b_and_c_exactly(b, nc, c, h, p, n, g):
    """x, B and C in bf16 (the served dtypes) are widened exactly: the
    same y and states as their f32 copies, bit for bit."""
    rng = np.random.default_rng(17 + c)
    x, dt, cum, B, C = (torch.tensor(a) for a in
                        _chunk_inputs(rng, b, nc, c, h, p, n, g))
    bf = [a.to(torch.bfloat16) for a in (x, B, C)]
    y1, s1 = K5.ssd_chunk(bf[0], dt, cum, bf[1], bf[2])
    y2, s2 = K5.ssd_chunk(bf[0].float(), dt, cum, bf[1].float(),
                          bf[2].float())
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("b,nc,c,h,p,n,g", [
    (1, 2, 32, 2, 16, 16, 1),
    (2, 2, 64, 4, 64, 128, 1),    # the wgmma body's shape class
    (1, 1, 100, 6, 64, 64, 3),    # a ragged tile of 64, groups
])
def test_ssd_chunk_served_dtypes_match_tpu_kernel(b, nc, c, h, p, n, g):
    """x, B and C in bf16: the port's plain version against the TPU
    kernel (interpret mode) on the same values widened to f32."""
    rng = np.random.default_rng(29 + c + g)
    x, dt, cum, B, C = _chunk_inputs(rng, b, nc, c, h, p, n, g)
    x, B, C = (torch.tensor(a).to(torch.bfloat16) for a in (x, B, C))
    wide = [a.float().numpy() for a in (x, B, C)]
    rep = h // g
    want_y, want_s = ops.ssd_chunk(
        jnp.asarray(wide[0]), jnp.asarray(dt), jnp.asarray(cum),
        jnp.repeat(jnp.asarray(wide[1]), rep, axis=3),
        jnp.repeat(jnp.asarray(wide[2]), rep, axis=3), interpret=True)
    got_y, got_s = K5.ssd_chunk(x, torch.tensor(dt), torch.tensor(cum), B, C)
    assert got_y.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **KERNEL_TOL)


def test_ssd_chunk_body_by_dtype_and_shape_class():
    """The wgmma body takes x, B and C in bf16 at p = 64, n a multiple
    of 64 and c <= 256, starting on 16 bytes; everything else goes to
    the CUDA-core body."""
    bf16, f32 = torch.bfloat16, torch.float32

    def body(c=256, p=64, n=128, xd=bf16, bcd=bf16, offset=0):
        x = torch.zeros(1 * 2 * c * 4 * p + offset, dtype=xd)[offset:]
        B = torch.zeros(1, 2, c, 1, n, dtype=bcd)
        return K5.body_for(x.view(1, 2, c, 4, p), B, B.clone())

    assert body() == "wgmma"
    assert body(n=64) == body(n=256) == body(c=100) == "wgmma"
    assert body(bcd=f32) == "cuda_core"
    assert body(xd=f32, bcd=f32) == "cuda_core"
    assert body(p=16) == body(p=32) == body(n=96) == "cuda_core"
    assert body(c=512) == "cuda_core"
    assert body(offset=1) == "cuda_core"          # x off 16 bytes


def test_ssd_chunk_large_decay_stays_finite():
    """cum falls to about -500 over a chunk with the JAX init (A = -e,
    dt ~ 0.8): the decays are single exponents of differences, so
    nothing overflows."""
    rng = np.random.default_rng(8)
    x, _, _, B, C = _chunk_inputs(rng, 1, 1, 256, 2, 16, 16, 1)
    dt = np.full((1, 1, 256, 2), 0.8, np.float32)
    cum = np.cumsum(dt * -np.e, axis=2).astype(np.float32)
    assert cum.min() < -500
    y, s = K5.ssd_chunk(*(torch.tensor(a) for a in (x, dt, cum, B, C)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("bad,exc", [
    (dict(x=torch.ones(1, 1, 8, 2, 65)), ValueError),      # p > 64
    (dict(B=torch.ones(1, 1, 8, 1, 300), C=torch.ones(1, 1, 8, 1, 300)),
     ValueError),                                          # n > 256
    (dict(B=torch.ones(1, 1, 8, 3, 4), C=torch.ones(1, 1, 8, 3, 4)),
     ValueError),                                          # h % g != 0
    (dict(dt=torch.ones(1, 1, 8, 2, dtype=torch.float64)), TypeError),
    (dict(cum=torch.ones(1, 1, 2, 8).transpose(2, 3)), ValueError),
    (dict(B=torch.ones(1, 1, 8, 1, 4, dtype=torch.float16),
          C=torch.ones(1, 1, 8, 1, 4, dtype=torch.float16)), TypeError),
    (dict(C=torch.ones(1, 1, 8, 1, 4, dtype=torch.bfloat16)),
     TypeError),                                           # B f32, C bf16
    (dict(B=torch.ones(1, 1, 8, 1, 4, dtype=torch.bfloat16),
          C=torch.ones(1, 1, 8, 1, 4, dtype=torch.bfloat16)),
     TypeError),                                    # x f32, B and C bf16
])
def test_ssd_chunk_rejects_what_the_kernel_does_not_take(bad, exc):
    args = dict(x=torch.ones(1, 1, 8, 2, 4), dt=torch.ones(1, 1, 8, 2),
                cum=torch.ones(1, 1, 8, 2), B=torch.ones(1, 1, 8, 1, 4),
                C=torch.ones(1, 1, 8, 1, 4))
    args.update(bad)
    before = K5.ssd_chunk.plain_calls
    with pytest.raises(exc):
        K5.ssd_chunk(**args)
    assert K5.ssd_chunk.plain_calls == before


def _seq_inputs(rng, b, l, h, p, g, n):
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, l, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("Lq,chunk,h,p,g,n", [
    (64, 16, 4, 8, 1, 16),
    (50, 16, 4, 8, 2, 8),       # ragged length + groups
    (32, 32, 2, 4, 1, 4),       # single chunk
])
def test_ssd_chunked_matches_jax_and_reference(Lq, chunk, h, p, g, n):
    rng = np.random.default_rng(Lq + g)
    a = _seq_inputs(rng, 2, Lq, h, p, g, n)
    t = [torch.tensor(v) for v in a]
    y, s = M.ssd_chunked(*t, chunk=chunk)
    jy, js = JM.ssd_chunked(*(jnp.asarray(v) for v in a), chunk=chunk)
    ry, rs = M.ssd_reference(*t)
    assert y.shape == (2, Lq, h, p) and s.shape == (2, h, p, n)
    for got, want in ((y, jy), (s, js), (y, ry), (s, rs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **SSD_TOL)


def test_ssd_chunked_carries_its_state():
    """Chunked SSD with an initial state == the reference over the
    concatenated sequence (ragged second part)."""
    rng = np.random.default_rng(3)
    l1, l2 = 32, 27
    x, dt, A, B, C = (torch.tensor(v) for v in
                      _seq_inputs(rng, 1, l1 + l2, 2, 4, 1, 8))
    y_all, s_all = M.ssd_reference(x, dt, A, B, C)
    _, s1 = M.ssd_chunked(x[:, :l1], dt[:, :l1], A, B[:, :l1], C[:, :l1],
                          chunk=16)
    y2, s2 = M.ssd_chunked(x[:, l1:], dt[:, l1:], A, B[:, l1:], C[:, l1:],
                           chunk=16, init_state=s1)
    torch.testing.assert_close(y2, y_all[:, l1:], **SSD_TOL)
    torch.testing.assert_close(s2, s_all, **SSD_TOL)
    jy, js = JM.ssd_chunked(*(jnp.asarray(v.numpy()) for v in
                              (x[:, l1:], dt[:, l1:], A, B[:, l1:],
                               C[:, l1:])),
                            chunk=16, init_state=jnp.asarray(s1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), **SSD_TOL)


def test_ssd_chunked_goes_through_k5_once():
    rng = np.random.default_rng(5)
    t = [torch.tensor(v) for v in _seq_inputs(rng, 1, 70, 2, 4, 1, 8)]
    before = K5.ssd_chunk.plain_calls
    M.ssd_chunked(*t, chunk=32)
    assert K5.ssd_chunk.plain_calls == before + 1


def test_ssd_chunked_passes_bf16_b_and_c_to_k5_once(monkeypatch):
    """In bf16, `ssd_chunked` hands K5 its x, B and C as they are (no
    f32 copies): one call, with the same result as the f32 copies of
    the inputs give."""
    rng = np.random.default_rng(6)
    x, dt, A, B, C = (torch.tensor(v) for v in
                      _seq_inputs(rng, 1, 70, 2, 4, 1, 8))
    x, B, C = (a.to(torch.bfloat16) for a in (x, B, C))
    seen = []

    def spy(*a):
        seen.append(tuple(t.dtype for t in a))
        return K5.ssd_chunk(*a)
    monkeypatch.setattr(M, "ssd_chunk", spy)
    y, s = M.ssd_chunked(x, dt, A, B, C, chunk=32)
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf16, f32, f32, bf16, bf16)]
    y2, s2 = M.ssd_chunked(x.float(), dt, A, B.float(), C.float(), chunk=32)
    assert y.dtype == bf16
    torch.testing.assert_close(y, y2.to(bf16), rtol=0, atol=0)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)

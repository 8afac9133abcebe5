"""Fused RMSNorm (K4a, K4b): the port's wrappers on CPU tensors (their
plain versions) against the JAX package's Pallas kernels (interpret
mode) and its pure-jnp oracles, at the shapes of tests/test_kernels.py
and with its tolerances. The CUDA kernel's own check against its plain
version needs a card: tests/test_torch_cuda.py. `_plan`, the pure
function that chooses the kernel's body and geometry, is checked here:
the vector body for every shape the served models launch, the general
body for the rest, and a geometry that covers each row once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.configs import get_arch
from repro_torch.kernels import rmsnorm as RN

# tests/test_kernels.py's TOL
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounding done once, by JAX, then carried over exactly)."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 128, 512), "float32"),
    ((2, 300, 384), "bfloat16"),   # ragged rows
    ((1000, 256), "float32"),
    ((64, 128), "bfloat16"),       # qk-norm rows of head_dim 128
    ((1, 2560), "bfloat16"),       # a decode step's hidden norm
    ((32, 128), "bfloat16"),       # a decode step's q-norm
])
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    r = np.random.default_rng(0)
    jx, tx = _pair(r.normal(size=shape), dtype)
    w = (r.normal(size=shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    before = RN.rmsnorm.plain_calls, RN.rmsnorm.launches
    got = RN.rmsnorm(tx, tw, eps=1e-6)
    assert (RN.rmsnorm.plain_calls, RN.rmsnorm.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = ops.rmsnorm(jx, jw, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(jx, jw)),
                               **TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [
    ((3, 100, 256), "float32"),
    ((2, 300, 384), "bfloat16"),
    ((1, 1, 2560), "bfloat16"),    # the decode step's residual stream
])
def test_rmsnorm_residual_matches_pallas_and_ref(shape, dtype):
    r = np.random.default_rng(1)
    jx, tx = _pair(r.normal(size=shape), dtype)
    jr, tr = _pair(r.normal(size=shape), dtype)
    w = (r.normal(size=shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    got_n, got_r = RN.rmsnorm_residual(tx, tr, tw, eps=1e-6)
    pn, pr = ops.rmsnorm_residual(jx, jr, jw, interpret=True)
    wn, wr = ref.rmsnorm_residual_ref(jx, jr, jw)
    for want_n, want_r in ((pn, pr), (wn, wr)):
        np.testing.assert_allclose(_np(got_n), _np(want_n), **TOL[dtype])
        # the residual is one rounding of the f32 sum in both packages
        np.testing.assert_array_equal(_np(got_r), _np(want_r))


def test_rmsnorm_residual_stream_is_bitwise_the_bf16_add():
    """K4b's residual output equals the JAX model's bf16 ``h + y``."""
    r = np.random.default_rng(2)
    jx, tx = _pair(r.normal(size=(5, 2560)), "bfloat16")
    jr, tr = _pair(r.normal(size=(5, 2560)), "bfloat16")
    _, res = RN.rmsnorm_residual(tx, tr, torch.ones(2560))
    np.testing.assert_array_equal(_np(res), _np(jx + jr))


@pytest.mark.parametrize("bad,exc", [
    (dict(x=torch.ones(4, 8, dtype=torch.float16)), TypeError),
    (dict(w=torch.ones(7)), ValueError),
    (dict(x=torch.ones(8, 4).t()), ValueError),
    (dict(x=torch.ones(2, 8193), w=torch.ones(8193)), ValueError),
    (dict(r=torch.ones(4, 8, dtype=torch.bfloat16)), TypeError),
    (dict(r=torch.ones(2, 8)), ValueError),
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, exc):
    a = dict(x=torch.ones(4, 8), r=torch.ones(4, 8), w=torch.ones(8))
    a.update(bad)
    with pytest.raises(exc):
        if "r" in bad:
            RN.rmsnorm_residual(a["x"], a["r"], a["w"])
        else:
            RN.rmsnorm(a["x"], a["w"])


# ------------------------------------------------------------- _plan
BF16, F32 = torch.bfloat16, torch.float32


def _served_shapes(arch, S):
    """The (R, D) of every K4a and K4b call of ``arch`` at full width
    over S positions (B = 1): the hidden norms, the q/k-norm rows (dense)
    and the Mamba2 gate norm (ssm, hybrid)."""
    cfg = get_arch(arch)
    shapes = {(S, cfg.d_model)}
    if cfg.family == "dense" and cfg.qk_norm:
        shapes |= {(S * cfg.n_heads, cfg.head_dim_),
                   (S * cfg.n_kv_heads, cfg.head_dim_)}
    if cfg.family in ("ssm", "hybrid"):
        shapes.add((S, cfg.d_inner))
    return sorted(shapes)


# the serving smoke's prompts (chip_smoke.SERVE_CATALOGUE and
# SERVE_SSM_CATALOGUE) and a decode step (S = 1)
@pytest.mark.parametrize("arch,S", [
    ("qwen3-4b", 256), ("qwen3-4b", 512), ("qwen3-4b", 2048),
    ("qwen3-4b", 1), ("mamba2-780m", 512), ("mamba2-780m", 2000),
    ("mamba2-780m", 1), ("zamba2-2.7b", 1024), ("zamba2-2.7b", 1)])
def test_plan_sends_every_served_shape_to_the_vector_body(arch, S):
    cfg = get_arch(arch)
    assert (cfg.pdtype, cfg.cdtype) == (BF16, BF16)
    for R, D in _served_shapes(arch, S):
        plan = RN._plan(R, D, BF16, BF16, True)
        assert plan.body == "vector", (arch, R, D, plan)
        # a decode step's wide row: one vector a thread, one block a row
        if R == 1 and D > 256:
            assert (plan.vectors_per_thread, plan.rows_per_block) == (1, 1)
            assert plan.threads_per_row == D // 8


@pytest.mark.parametrize("R,D,dtype,aligned", [
    (7, 1001, BF16, True),      # D not a multiple of 8 bf16
    (5, 1001, F32, True),
    (1, 1, F32, True),
    (3, 6, F32, True),          # 6 f32 is not whole 16-byte vectors
    (2048, 2560, BF16, False),  # a pointer off 16 bytes
    (1, 128, F32, False),
])
def test_plan_sends_odd_widths_and_misaligned_pointers_to_general(
        R, D, dtype, aligned):
    plan = RN._plan(R, D, dtype, BF16, aligned)
    assert plan.body == "general"
    assert (plan.rows_per_block, plan.vectors_per_thread, plan.grid) == (
        1, 0, R)
    assert 32 <= plan.threads_per_row <= 256
    assert plan.threads_per_row % 32 == 0


def _covered(plan, R, nv):
    """How often the kernel's index map (csrc/rmsnorm.cu) visits each
    row, and each vector of a row: (rows (R,), vectors (nv,))."""
    G, rows_pb, vpt, grid = (plan.threads_per_row, plan.rows_per_block,
                             plan.vectors_per_thread, plan.grid)
    rows = np.zeros(R, np.int64)
    for b in range(grid):
        for base in range(b * rows_pb, R, grid * rows_pb):
            rows[base:min(base + rows_pb, R)] += 1
    g = np.arange(G)[:, None] + G * np.arange(vpt)[None, :]
    vecs = np.bincount(g[g < nv], minlength=nv)
    return rows, vecs


@pytest.mark.parametrize("dtype,wdtype", [(BF16, BF16), (BF16, F32),
                                          (F32, BF16), (F32, F32)])
def test_plan_covers_every_row_once_within_the_kernels_instances(
        dtype, wdtype):
    V = 16 // dtype.itemsize
    for R in (1, 3, 8, 32, 48, 132, 300, 2000, 2048, 65536):
        for D in (8, 64, 128, 256, 384, 1536, 2560, 3072, 5120, 8192):
            plan = RN._plan(R, D, dtype, wdtype, True)
            assert plan.body == "vector"
            G, vpt = plan.threads_per_row, plan.vectors_per_thread
            threads = G * plan.rows_per_block
            assert vpt in RN.VECTORS
            assert threads <= RN.max_threads(vpt) and threads % 32 == 0
            assert (G & (G - 1)) == 0 if G <= 32 else G % 32 == 0
            rows, vecs = _covered(plan, R, D // V)
            assert (rows == 1).all(), (R, D, plan)
            assert (vecs == 1).all(), (R, D, plan)


# ------------------------------------------------------- _bwd_plan
def _train_shapes(arch, tokens):
    """The (R, D) of every K4a-bwd and K4b-bwd call of ``arch`` at full
    width over ``tokens`` positions: the hidden norms and the q- and
    k-norms' rows."""
    cfg = get_arch(arch)
    return sorted({(tokens, cfg.d_model),
                   (tokens * cfg.n_heads, cfg.head_dim_),
                   (tokens * cfg.n_kv_heads, cfg.head_dim_)})


# the train phase's global batch of 4 x 1,024 tokens and its 2-layer
# checks' 2 x 1,024 (chip_smoke.TRAIN_FULL, TRAIN_CUT)
@pytest.mark.parametrize("tokens", [4096, 2048])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_plan_sends_every_training_shape_to_the_vector_body(tokens,
                                                                 dtype):
    for R, D in _train_shapes("qwen3-4b", tokens):
        plan = RN._bwd_plan(R, D, dtype, True)
        assert plan.body == "vector", (R, D, plan)
        assert plan.vectors_per_thread in RN.BWD_VECTORS


# the geometries measured on an H100 (scripts/rmsnorm_timing.py
# --bwd_sweep, PERF.md): a wide row 320 threads (a vector each), three
# rows a block, a block a SM; a 128-wide row 16 lanes, 32 rows a block
@pytest.mark.parametrize("R,D,want", [
    (4096, 2560, ("vector", 320, 3, 1, 132)),
    (2048, 2560, ("vector", 320, 3, 1, 132)),
    (131072, 128, ("vector", 16, 32, 1, 264)),
    (32768, 128, ("vector", 16, 32, 1, 264)),
    (16384, 128, ("vector", 16, 32, 1, 264)),
])
def test_bwd_plan_is_pinned_at_the_training_shapes(R, D, want):
    assert tuple(RN._bwd_plan(R, D, BF16, True, 132)) == want


@pytest.mark.parametrize("R,D,dtype,aligned", [
    (7, 1001, BF16, True),      # D not a multiple of 8 bf16
    (5, 1001, F32, True),
    (1, 1, F32, True),
    (3, 6, F32, True),          # 6 f32 is not whole 16-byte vectors
    (4096, 2560, BF16, False),  # a pointer off 16 bytes
    (1, 128, F32, False),
    (2, 8192, F32, True),       # 2,048 vectors: no instance's block
])
def test_bwd_plan_sends_the_rest_to_the_general_body(R, D, dtype, aligned):
    plan = RN._bwd_plan(R, D, dtype, aligned)
    assert plan.body == "general" and plan.vectors_per_thread == 0
    G = plan.threads_per_row
    assert G == (32 if D <= RN.BWD_WARP_ROW_D else RN.BWD_THREADS)
    assert plan.rows_per_block == RN.BWD_THREADS // G
    assert 1 <= plan.grid <= -(-R // plan.rows_per_block)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_plan_covers_every_row_once_within_the_kernels_instances(
        dtype):
    """The backward walks rows as the forward does (a grid stride of
    rows_per_block rows): every row once, every vector of a row once, a
    block within its instance's __launch_bounds__ and the dw partials in
    shared memory."""
    V = 16 // dtype.itemsize
    for R in (1, 3, 8, 32, 48, 132, 300, 2048, 4096, 32768, 131072):
        for D in (8, 64, 96, 128, 256, 1536, 2560, 3000, 4096, 8192):
            if D % V:
                continue
            plan = RN._bwd_plan(R, D, dtype, True)
            if plan.body == "general":
                assert D // V > RN.BWD_WIDE_ROW_THREADS, (R, D, plan)
                continue
            G, vpt = plan.threads_per_row, plan.vectors_per_thread
            threads = G * plan.rows_per_block
            assert vpt in RN.BWD_VECTORS
            assert threads <= RN.bwd_max_threads(vpt) and threads % 32 == 0
            assert (G & (G - 1)) == 0 if G <= 32 else G % 32 == 0
            assert 4 * (plan.rows_per_block * D + 128) <= 200 * 1024
            rows, vecs = _covered(plan, R, D // V)
            assert (rows == 1).all(), (R, D, plan)
            assert (vecs == 1).all(), (R, D, plan)

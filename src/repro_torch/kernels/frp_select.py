"""ESFF FRP candidate selection (paper Alg. 3): the CUDA kernel's
wrappers and their plain PyTorch versions.

Port of the TPU kernel `repro.kernels.sched_weights.frp_select` (Pallas)
and of the engine's inline FRP scan (`repro.core.jax_policies`,
``ESFFKernel.on_exec_done``). The kernel is ``csrc/frp_select.cu``; see
its header for the bound and the design.

* `frp_select` — the TPU kernel's f32 contract over one (F,) row.
* `frp_select_lanes` — the engine's f64 contract over (L, F) lanes,
  with ``beta``, no clamp on the running means and, for ESFF-H, the
  optional cold-aware term ``coldK``.

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

BIG = 1e30

_P = _build.PTR
_ARGTYPES = {
    "frp_select_f32": [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, _P, _P, _P],
    "frp_select_lanes_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.c_int, ctypes.c_int, _P, _P, _P],
}


def _fn(symbol: str):
    return _build.c_entry("frp_select", symbol, _ARGTYPES[symbol])


def _check(name, x, dtype, shape, device):
    _build.check_tensor(name, x, (dtype,), device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{shape}")


# ------------------------------------------------------------ f32 contract
def frp_select_plain(t_e, t_l, t_v, n_w, K, tv_j, self_idx):
    """Plain version of the f32 contract (`kernels/ref.py`
    ``frp_select_ref``): returns (best weight () f32, best index ()
    i32, -1 if none qualifies)."""
    nw = n_w.to(torch.float32)
    k = K.to(torch.float32)
    n_e = nw + 1.0 - (t_l + tv_j) * k / torch.clamp_min(t_e, 1e-9)
    w = t_e + (t_l + t_v) * (k + 1.0) / torch.clamp_min(n_e, 1e-9)
    idx = torch.arange(t_e.shape[0], device=t_e.device)
    valid = (nw > 0) & (n_e > 0) & (idx != int(self_idx))
    w = torch.where(valid, w, BIG)
    i = torch.argmin(w)
    bw = w[i]
    return bw, torch.where(bw >= BIG, -1, i).to(torch.int32)


def frp_select(t_e, t_l, t_v, n_w, K, tv_j: float, self_idx: int):
    """FRP selection over one row of F functions (the TPU kernel's f32
    contract). ``t_e``/``t_l``/``t_v`` (F,) f32, ``n_w``/``K`` (F,) i32,
    ``tv_j`` and ``self_idx`` Python scalars. Returns (best weight ()
    f32, best index () i32, -1 if none)."""
    dev = t_e.device
    F = t_e.shape[0] if t_e.dim() == 1 else -1
    if F < 1:
        raise ValueError(f"frp_select: t_e must be (F,) with F >= 1, got "
                         f"{tuple(t_e.shape)}")
    for name, x, dt in (("t_e", t_e, torch.float32),
                        ("t_l", t_l, torch.float32),
                        ("t_v", t_v, torch.float32),
                        ("n_w", n_w, torch.int32), ("K", K, torch.int32)):
        _check(f"frp_select: {name}", x, dt, (F,), dev)
    if dev.type == "cpu":
        frp_select.plain_calls += 1
        return frp_select_plain(t_e, t_l, t_v, n_w, K, tv_j, self_idx)
    fn = _fn("frp_select_f32")
    _build.require_cuda("frp_select", dev)
    best_w = torch.empty((1,), dtype=torch.float32, device=dev)
    best_i = torch.empty((1,), dtype=torch.int32, device=dev)
    rc = fn(t_e.data_ptr(), t_l.data_ptr(), t_v.data_ptr(),
            n_w.data_ptr(), K.data_ptr(), float(tv_j), int(self_idx), F,
            best_w.data_ptr(), best_i.data_ptr(), _build.stream_of(dev))
    _build.launch_check(rc, "frp_select_f32")
    frp_select.launches += 1
    return best_w[0], best_i[0]


frp_select.launches = 0
frp_select.plain_calls = 0


# ---------------------------------------------------- f64 engine contract
def frp_select_lanes_plain(means, t_cold, t_evict, nw, K, tv_j, self_idx,
                           beta, coldK=None):
    """Plain version of the engine's f64 contract
    (`repro.core.jax_policies` ESFF FRP, in the same order of
    operations; ``coldK`` (L, F) i32, ESFF-H's COLD slots a function,
    is subtracted after Eq. 7): returns (best weight (L,) f64, best
    index (L,) i32, -1 if none qualifies)."""
    nwf = nw.to(torch.float64)
    k = K.to(torch.float64)
    n_e = nwf + 1.0 - (t_cold + tv_j[:, None]) * k / means
    if coldK is not None:
        n_e = n_e - coldK.to(torch.float64)
    w = (means + beta[:, None] * (t_cold + t_evict) * (k + 1.0)
         / torch.clamp_min(n_e, 1e-30))
    idx = torch.arange(means.shape[1], device=means.device)
    valid = (nwf > 0) & (n_e > 0) & (idx[None] != self_idx[:, None])
    w = torch.where(valid, w, BIG)
    bi = torch.argmin(w, dim=1)
    bw = w.gather(1, bi[:, None])[:, 0]
    return bw, torch.where(bw >= BIG, -1, bi).to(torch.int32)


def frp_select_lanes(means, t_cold, t_evict, nw, K, tv_j, self_idx, beta,
                     coldK=None):
    """FRP selection for L lanes at once (the engine's f64 contract).

    ``means``, ``t_cold``, ``t_evict`` (L, F) f64; ``nw``, ``K`` (L, F)
    i32; ``tv_j`` (L,) f64 (the finishing function's eviction time);
    ``self_idx`` (L,) i32; ``beta`` (L,) f64; ``coldK`` (L, F) i32 or
    None (ESFF-H's cold-aware term). Returns (best weight (L,)
    f64, best index (L,) i32, -1 if none qualifies). The caller keeps
    the reference's decision: replace iff ``best_i >= 0 and best_w <
    w_own``."""
    dev = means.device
    if means.dim() != 2 or means.shape[0] < 1 or means.shape[1] < 1:
        raise ValueError(f"frp_select_lanes: means must be (L, F) with "
                         f"L, F >= 1, got {tuple(means.shape)}")
    L, F = means.shape
    f64, i32 = torch.float64, torch.int32
    for name, x, dt, shape in (
            ("means", means, f64, (L, F)), ("t_cold", t_cold, f64, (L, F)),
            ("t_evict", t_evict, f64, (L, F)), ("nw", nw, i32, (L, F)),
            ("K", K, i32, (L, F)), ("tv_j", tv_j, f64, (L,)),
            ("self_idx", self_idx, i32, (L,)), ("beta", beta, f64, (L,))):
        _check(f"frp_select_lanes: {name}", x, dt, shape, dev)
    if coldK is not None:
        _check("frp_select_lanes: coldK", coldK, i32, (L, F), dev)
    if dev.type == "cpu":
        frp_select_lanes.plain_calls += 1
        return frp_select_lanes_plain(means, t_cold, t_evict, nw, K, tv_j,
                                      self_idx, beta, coldK)
    fn = _fn("frp_select_lanes_f64")
    _build.require_cuda("frp_select_lanes", dev)
    best_w = torch.empty((L,), dtype=f64, device=dev)
    best_i = torch.empty((L,), dtype=i32, device=dev)
    rc = fn(means.data_ptr(), t_cold.data_ptr(), t_evict.data_ptr(),
            nw.data_ptr(), K.data_ptr(), tv_j.data_ptr(),
            self_idx.data_ptr(), beta.data_ptr(),
            None if coldK is None else coldK.data_ptr(), L, F,
            best_w.data_ptr(),
            best_i.data_ptr(), _build.stream_of(dev))
    _build.launch_check(rc, "frp_select_lanes_f64")
    frp_select_lanes.launches += 1
    return best_w, best_i


frp_select_lanes.launches = 0
frp_select_lanes.plain_calls = 0

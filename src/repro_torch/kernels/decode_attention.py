"""Single-token GQA attention over a KV cache (K3): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.decode_attention.decode_attention`
(Pallas): one new query position per sequence attends the positions
``<= length`` of a (B, T, KVH, D) cache; the G = H / KVH query heads of
a kv head share one pass over it; f32 products and softmax, the output
in q's dtype. The kernel cuts the attended positions into ranges
(`cluster_plan`), one block each; the ranges of a kv head are the blocks
of one thread-block cluster, which merge their partial softmaxes through
each other's shared memory, in the same launch.
``length`` is a host ``int`` (the model keeps the cache's length as a
Python int), so a decode loop never reads the device. The kernel is
``csrc/decode_attention.cu``; see its header for the bound and the
design.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. A CPU tensor goes to the plain
version (counted in ``plain_calls``); a CUDA tensor launches the kernel
(counted in ``launches``) or raises. There is no fallback from a failed
build or launch to the plain version.

`mla_decode_attention` (K3-mla) is the decode attention of DeepSeek-V3's
multi-head latent attention over its latent cache, the attention core of
`repro.models.model._decode_mla` (plain einsums there: no TPU kernel):
with the key weights absorbed into the query, every query head attends
the one shared latent row ``[c_kv, k_rope]`` (R + DR dims) and reads
``c_kv`` back as its value. Its kernel is ``csrc/mla_decode.cu``, its
plain version `mla_decode_attention_plain`; it has counts of its own.
The kernel has two bodies, and `mla_body_for` picks one: "mma" (the
tensor cores, mma.sync over bf16 tiles of ``c_kv``) for bf16 at the
(R, DR) of MLA_DIMS, "cuda_core" (f32 FMAs) for f32. A call may name
the body (``body=``), so the card tests run both on the same bf16
inputs; launches are counted by body in ``body_launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = tuple(_build.DTYPE_CODE)
# a block of the kernel takes at least MIN_SPLIT positions, in whole
# multiples of SPLIT_ALIGN; a cluster holds at most MAX_CLUSTER blocks
# (16: a non-portable cluster size, which Hopper allows)
MIN_SPLIT = 64
SPLIT_ALIGN = 16
MAX_CLUSTER = 16
_P = _build.PTR
_I = ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]


def cluster_plan(n_valid: int, n_heads_kv: int, n_sms: int):
    """(per, n_splits): how the kernel cuts the ``n_valid`` attended
    positions into ``n_splits`` contiguous ranges of ``per`` positions
    (the last one shorter), the blocks of one cluster per kv head
    (``n_heads_kv`` = B * KVH clusters). About one block per SM, at most
    MAX_CLUSTER blocks a cluster, none shorter than MIN_SPLIT positions
    (unless there is one), none empty."""
    want = -(-n_sms // n_heads_kv)
    n_splits = max(1, min(want, MAX_CLUSTER, n_valid // MIN_SPLIT))
    per = -(-n_valid // n_splits)
    per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return per, -(-n_valid // per)


def _ranges(name: str, length, T: int, n_clusters: int, dev):
    """Check ``length`` (a Python int >= 0: the positions ``<= length``
    are attended) and, on a CUDA device, plan the kernel's ranges over
    the ``min(length + 1, T)`` valid positions of each of ``n_clusters``
    clusters: (n_valid, per, n_splits) (`cluster_plan`); None on any
    other device."""
    if isinstance(length, bool) or not isinstance(length, int) \
            or length < 0:
        raise TypeError(f"{name}: length must be a Python int >= 0, got "
                        f"{length!r}")
    if dev.type != "cuda":
        return None
    n_valid = min(length + 1, T)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return (n_valid, *cluster_plan(n_valid, n_clusters,
                                   _build.sm_count(index)))


def decode_attention_plain(q, k_cache, v_cache, length: int, *,
                           scale=None):
    """Plain version (`repro.kernels.ref.decode_attention_ref`, with the
    kernel's ``* scale``). Like the kernel it reads only the positions
    ``<= length``, so whatever lies past them cannot leak in."""
    B, _, H, D = q.shape
    KVH = k_cache.shape[2]
    n = length + 1
    g = H // KVH
    scale = scale or 1.0 / math.sqrt(D)
    kf = k_cache[:, :n].repeat_interleave(g, dim=2).to(torch.float32)
    vf = v_cache[:, :n].repeat_interleave(g, dim=2).to(torch.float32)
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kf) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length: int, *, scale=None):
    """q (B, 1, H, D); caches (B, T, KVH, D); ``length`` a Python int
    >= 0 (positions ``<= length`` are attended). Returns (B, 1, H, D).
    H % KVH == 0, D in HEAD_DIMS; f32 or bf16, one dtype for all."""
    name = "decode_attention"
    dev = q.device
    _build.check_tensor(f"{name}: q", q, DTYPES, dev, ndim=4)
    for nm, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_tensor(f"{name}: {nm}", x, (q.dtype,), dev, ndim=4)
    B, S1, H, D = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or S1 != 1):
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (B, 1, H, D) "
                         f"and both caches (B, T, KVH, D), got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if min(B, T, KVH) < 1 or H % KVH != 0:
        raise ValueError(f"{name}: need B, T >= 1 and H ({H}) a multiple "
                         f"of KVH ({KVH})")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}, kernel takes D in "
                         f"{HEAD_DIMS}")
    ranges = _ranges(name, length, T, B * KVH, dev)
    scale = scale or 1.0 / math.sqrt(D)
    if dev.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      scale=scale)
    fn = _build.c_entry("decode_attention", "decode_attention", _ARGTYPES)
    _build.require_cuda(name, dev)
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError(f"{name}: the kernel reads 16-byte vectors; q and "
                         "the caches must start on a 16-byte boundary")
    n_valid, per, n_splits = ranges
    out = torch.empty_like(q)
    rc = fn(_build.DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(), B, T, KVH, H // KVH, D,
            n_valid - 1, per, n_splits, float(scale),
            _build.stream_of(dev))
    _build.launch_check(rc, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0


# ------------------------------------------------------------ K3-mla
# the (latent, rotary) dims the MLA decode kernel takes: DeepSeek-V3's
# kv_lora_rank and qk_rope_dim
MLA_DIMS = ((512, 64),)
# body, dtype, q_abs, q_rope, c_kv, k_rope, lat, B, T, H, R, DR, length,
# per, n_splits, scale, stream
_MLA_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _I, ctypes.c_float, _P]
# the kernel's bodies, the entry's body codes 0, 1
MLA_BODIES = ("cuda_core", "mma")
# the query heads a block of the kernel serves (its kHG)
MLA_HEAD_GROUP = 16


def mla_decode_attention_plain(q_abs, q_rope, c_kv, k_rope, length: int, *,
                               scale: float):
    """Plain version: the attention core of `repro.models.model.
    _decode_mla` (its einsums, with the kernel's ``* scale``): f32 scores
    ``q_abs . c_kv + q_rope . k_rope`` over the positions ``<= length``,
    the softmax in f32, its weights cast to q's dtype before the f32
    product with ``c_kv``, the result cast to q's dtype. It reads only
    those positions."""
    n = min(length + 1, c_kv.shape[1])
    c = c_kv[:, :n].to(torch.float32)
    s = (torch.einsum("bshr,btr->bhst", q_abs.to(torch.float32), c)
         + torch.einsum("bshk,btk->bhst", q_rope.to(torch.float32),
                        k_rope[:, :n].to(torch.float32))) * scale
    p = torch.softmax(s, dim=-1).to(q_abs.dtype).to(torch.float32)
    return torch.einsum("bhst,btr->bshr", p, c).to(q_abs.dtype)


def mla_body_for(q_abs, q_rope, c_kv, k_rope) -> str:
    """The K3-mla body that takes these (checked) inputs: "mma" (the
    tensor cores) for bf16 at (R, DR) in MLA_DIMS, every input starting
    on 16 bytes (its copies' rule); else "cuda_core"."""
    dims = (c_kv.shape[-1], k_rope.shape[-1])
    aligned = not any(x.data_ptr() & 15
                      for x in (q_abs, q_rope, c_kv, k_rope))
    if q_abs.dtype == torch.bfloat16 and dims in MLA_DIMS and aligned:
        return "mma"
    return "cuda_core"


def mla_decode_attention(q_abs, q_rope, c_kv, k_rope, length: int, *,
                         scale: float, body: str = None):
    """q_abs (B, 1, H, R), q_rope (B, 1, H, DR); c_kv (B, T, R), k_rope
    (B, T, DR); ``length`` a Python int >= 0 (positions ``<= length`` are
    attended). Returns lat (B, 1, H, R) in q's dtype. f32 or bf16, one
    dtype for all; on CUDA (R, DR) in MLA_DIMS and any H >= 1 (in groups
    of MLA_HEAD_GROUP heads); on the CPU, the plain version at any
    widths. ``body`` names the kernel's body (MLA_BODIES; "mma" takes
    bf16 only); None takes `mla_body_for`'s."""
    name = "mla_decode_attention"
    dev = q_abs.device
    _build.check_tensor(f"{name}: q_abs", q_abs, DTYPES, dev, ndim=4)
    _build.check_tensor(f"{name}: q_rope", q_rope, (q_abs.dtype,), dev,
                        ndim=4)
    for nm, x in (("c_kv", c_kv), ("k_rope", k_rope)):
        _build.check_tensor(f"{name}: {nm}", x, (q_abs.dtype,), dev, ndim=3)
    B, S1, H, R = q_abs.shape
    T, DR = c_kv.shape[1], k_rope.shape[2]
    if (S1 != 1 or tuple(q_rope.shape) != (B, 1, H, DR)
            or tuple(c_kv.shape) != (B, T, R)
            or tuple(k_rope.shape) != (B, T, DR)):
        raise ValueError(f"{name}: q_abs {tuple(q_abs.shape)} and q_rope "
                         f"{tuple(q_rope.shape)} must be (B, 1, H, R) and "
                         f"(B, 1, H, DR), c_kv {tuple(c_kv.shape)} and "
                         f"k_rope {tuple(k_rope.shape)} (B, T, R) and (B, "
                         "T, DR)")
    if min(B, T, H, R, DR) < 1:
        raise ValueError(f"{name}: every dim must be >= 1")
    if body is not None and body not in MLA_BODIES:
        raise ValueError(f"{name}: body {body!r}, the kernel has "
                         f"{MLA_BODIES}")
    ranges = _ranges(name, length, T, B * -(-H // MLA_HEAD_GROUP), dev)
    if dev.type == "cpu":
        mla_decode_attention.plain_calls += 1
        return mla_decode_attention_plain(q_abs, q_rope, c_kv, k_rope,
                                          length, scale=scale)
    if (R, DR) not in MLA_DIMS:
        raise ValueError(f"{name}: (R, DR) = ({R}, {DR}), kernel takes "
                         f"{MLA_DIMS}")
    fn = _build.c_entry("mla_decode", "mla_decode_attention", _MLA_ARGTYPES)
    _build.require_cuda(name, dev)
    if any(x.data_ptr() % 16 for x in (q_abs, q_rope, c_kv, k_rope)):
        raise ValueError(f"{name}: the kernel reads 16-byte vectors; every "
                         "input must start on a 16-byte boundary")
    rule = mla_body_for(q_abs, q_rope, c_kv, k_rope)
    body = rule if body is None else body
    if body == "mma" and rule != "mma":
        raise ValueError(f"{name}: the mma body takes bf16 only, not "
                         f"{q_abs.dtype}")
    n_valid, per, n_splits = ranges
    lat = torch.empty_like(q_abs)
    rc = fn(MLA_BODIES.index(body), _build.DTYPE_CODE[q_abs.dtype],
            q_abs.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
            k_rope.data_ptr(), lat.data_ptr(), B, T, H, R, DR, n_valid - 1,
            per, n_splits, float(scale), _build.stream_of(dev))
    _build.launch_check(rc, name)
    mla_decode_attention.launches += 1
    mla_decode_attention.body_launches[body] += 1
    return lat


mla_decode_attention.launches = 0
mla_decode_attention.body_launches = dict.fromkeys(MLA_BODIES, 0)
mla_decode_attention.plain_calls = 0


def mla_kernel_info(body: str, dtype=torch.bfloat16) -> dict:
    """What ``body``'s kernel takes on the current CUDA device for
    ``dtype``: its dynamic shared memory a block (``smem_bytes``) and how
    many of its blocks fit an SM (``blocks_per_sm``, the occupancy
    calculator's)."""
    f = _build.c_entry("mla_decode", "mla_decode_attention_info",
                       [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)])
    smem, blocks = _I(0), _I(0)
    _build.launch_check(f(MLA_BODIES.index(body), _build.DTYPE_CODE[dtype],
                          ctypes.byref(smem), ctypes.byref(blocks)),
                        "mla_decode_attention_info")
    return dict(smem_bytes=smem.value, blocks_per_sm=blocks.value)

"""AdamW with large-model memory options (counterpart of
`repro.optim.adamw`).

* ``moment_dtype``: f32 (default) or bf16 first and second moments.
* ``quantize_nu``: the int8 log-space block-quantised second moment of the
  JAX package (per-block max, blocks of ``nu_block`` on the trailing
  axis; `_q8_encode` / `_q8_decode`): 4x smaller nu.

All update math runs in f32 whatever the storage dtypes, and a bf16
parameter is cast once, as the JAX package's `adamw_update`. The state is
a dict: ``mu`` and ``nu`` map each parameter's name (the JAX tree's path
joined by dots, as ``Model.named_parameters`` names it) to its moment
(``nu`` to ``{"q", "scale"}`` when quantised), ``step`` is an int32
scalar tensor.

Unlike the JAX package's pure function, `adamw_update` updates the
parameters and the moments in place, a leaf at a time and a chunk of its
leading axis at a time (at most `CHUNK_ELEMENTS` elements: a layer of a
stacked leaf), so its f32 temporaries stay a chunk's size: a full-depth
Qwen3-4B's stacked ``w_gate`` is 896 M elements, 3.6 GB in f32. The
chunking changes no number (every operation is elementwise, the int8
blocks run along the last axis). ``opt_state_axes`` (the optimizer
state's sharding) waits for the sharding bullet (ROADMAP Queue 1,
item 6 (sharding)).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    quantize_nu: bool = False
    nu_block: int = 128


# the most elements of a leaf one chunk of the update takes
CHUNK_ELEMENTS = 1 << 25

# ------------------------------------------- int8 log-space block quant
# q in [0, 127] maps to blockmax * RATIO^(q / 127) with RATIO = 1e-6
# (the JAX package's scheme and constants; see repro/optim/adamw.py)
_LOG_RATIO = 1e-6
_LOG_DENOM = math.log(_LOG_RATIO)


def moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    """The storage dtype of the moments."""
    return getattr(torch, cfg.moment_dtype)


def _nu_scale_shape(shape, block: int):
    last = shape[-1] if len(shape) else 1
    return tuple(shape[:-1]) + (-(-last // block),)


def _blocks(x, block: int):
    """x padded with zeros on its last axis to a multiple of ``block``,
    viewed as (..., n_blocks, block)."""
    last = x.shape[-1]
    pad = (-last) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (-1, block))


def _q8_encode(x, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x >= 0 (second moments), f32 -> (int8 codes of x's shape, the f32
    block maxima (..., n_blocks))."""
    last = x.shape[-1]
    b = _blocks(x, block)
    bmax = b.amax(dim=-1)
    safe = bmax.clamp_min(1e-30)
    ratio = (b / safe[..., None]).clamp(_LOG_RATIO, 1.0)
    q = torch.round(127.0 * torch.log(ratio) / _LOG_DENOM)
    q = q.reshape(q.shape[:-2] + (-1,))[..., :last].to(torch.int8)
    return q, bmax.to(torch.float32)


def _q8_decode(q, bmax, block: int):
    last = q.shape[-1]
    b = _blocks(q, block).to(torch.float32)
    x = bmax[..., None] * torch.exp(b / 127.0 * _LOG_DENOM)
    x = torch.where(bmax[..., None] <= 0, torch.zeros_like(x), x)
    return x.reshape(x.shape[:-2] + (-1,))[..., :last]


def adamw_init(cfg: AdamWConfig, params: Dict[str, torch.Tensor]):
    """Zero moments for ``params`` (name -> tensor), on each parameter's
    device."""
    mdt = moment_dtype(cfg)

    def nu_like(p):
        if cfg.quantize_nu:
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros(_nu_scale_shape(p.shape,
                                                         cfg.nu_block),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    dev = next(iter(params.values())).device if params else None
    return {"mu": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                   for k, p in params.items()},
            "nu": {k: nu_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def tree_order(names):
    """``names`` in the order of the JAX tree's leaves (dicts flatten by
    sorted key, level by level)."""
    return sorted(names, key=lambda n: n.split("."))


def _rows(t: torch.Tensor):
    """Slices of t's leading axis of at most CHUNK_ELEMENTS elements each
    (the whole tensor when it has at most one row)."""
    if t.dim() == 0 or t.shape[0] <= 1:
        return [slice(None)]
    per = max(1, CHUNK_ELEMENTS // max(1, t[0].numel()))
    return [slice(i, i + per) for i in range(0, t.shape[0], per)]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares in f32, the leaves
    added in the JAX tree's order (a 0-d f32 tensor; no host sync)."""
    total = None
    for k in tree_order(tree):
        x = tree[k]
        s = sum(x[sl].to(torch.float32).square().sum() for sl in _rows(x))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state,
                 lr: Optional[float] = None):
    """One AdamW step on ``params`` (name -> tensor, updated in place)
    with ``grads`` (the same names). Returns (params, state, metrics)
    with the state's moments updated in place and ``step`` one further;
    metrics ``grad_norm`` and ``lr`` (0-d f32 tensors)."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.grad_clip / torch.clamp_min(gnorm, 1e-12)) \
        if cfg.grad_clip else 1.0
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu_new = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
        if cfg.quantize_nu:
            nu_f = _q8_decode(nu["q"], nu["scale"], cfg.nu_block)
        else:
            nu_f = nu.to(torch.float32)
        nu_new = cfg.b2 * nu_f + (1 - cfg.b2) * torch.square(g)
        delta = (mu_new / b1c) / (torch.sqrt(nu_new / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        mu.copy_(mu_new)
        if cfg.quantize_nu:
            q, s = _q8_encode(nu_new, cfg.nu_block)
            nu["q"].copy_(q)
            nu["scale"].copy_(s)
        else:
            nu.copy_(nu_new)

    for k in tree_order(params):
        p, g, mu, nu = params[k], grads[k], state["mu"][k], state["nu"][k]
        for sl in _rows(p):
            upd(p[sl], g[sl], mu[sl],
                {"q": nu["q"][sl], "scale": nu["scale"][sl]}
                if cfg.quantize_nu else nu[sl])
    state["step"] = step
    return params, state, {"grad_norm": gnorm,
                           "lr": torch.as_tensor(lr, dtype=torch.float32)}

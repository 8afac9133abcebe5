"""Training step factory (counterpart of `repro.train.train_step`): loss
and gradient through `Model.loss`, optional microbatch accumulation,
optional int8 gradient compression, then AdamW.

The JAX package accumulates microbatches under ``lax.scan``; here it is
a Python loop, each microbatch's backward freeing its activations before
the next, the gradients summed in ``accum_dtype`` and divided by the
number of microbatches, as there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch.distributed.compression import compress_grads_int8
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    compress_grads: bool = False
    # the gradient accumulator's dtype across microbatches
    accum_dtype: str = "float32"


def _as_tensors(batch, device):
    """The batch's token ids (numpy or tensors) as int64 on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` the model's own parameters by name
    (``dict(model.named_parameters())``), updated in place; ``batch``
    leaves (numpy or tensors) with a leading global-batch dim, split into
    ``tcfg.microbatches`` microbatches; metrics ``loss``, ``ce``,
    ``aux``, ``grad_norm`` and ``lr`` (0-d tensors on the model's device,
    ``lr`` on the host)."""
    device = model.device

    def grads_of(params, mb):
        for p in params.values():
            p.grad = None
        loss, m = model.loss(mb)
        loss.backward()
        return {"loss": loss.detach(), "ce": m["ce"].detach(),
                "aux": m["aux"].detach()}

    def train_step(params, opt_state, batch):
        batch = _as_tensors(batch, device)
        n_mb = tcfg.microbatches
        if n_mb > 1:
            adt = getattr(torch, tcfg.accum_dtype)
            acc: Dict[str, torch.Tensor] = {
                k: torch.zeros(p.shape, dtype=adt, device=p.device)
                for k, p in params.items()}
            metrics = None
            for i in range(n_mb):
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                m = grads_of(params, mb)
                for k, p in params.items():
                    acc[k] = acc[k] + p.grad.to(adt)
                    p.grad = None
                metrics = m if metrics is None else \
                    {k: metrics[k] + m[k] for k in m}
            grads = {k: g / n_mb for k, g in acc.items()}
            metrics = {k: v / n_mb for k, v in metrics.items()}
        else:
            metrics = grads_of(params, batch)
            grads = {k: p.grad for k, p in params.items()}
        if tcfg.compress_grads:
            grads = compress_grads_int8(grads)
        params, opt_state, om = adamw_update(tcfg.optimizer, params, grads,
                                             opt_state)
        for p in params.values():
            p.grad = None
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def init_optimizer(tcfg: TrainConfig, params):
    return adamw_init(tcfg.optimizer, params)

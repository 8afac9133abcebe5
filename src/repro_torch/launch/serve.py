"""Serving driver of the port: ESFF-scheduled multi-model edge serving
(counterpart of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --policy esff \
        --capacity 2 --requests 50            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Deploys a catalogue of small models as serverless functions and serves a
request stream with the selected scheduling policy; cold starts and
execution times are real measurements on the device (see
serving/engine.py), which is CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.models.config import ModelConfig
from repro_torch.serving import EdgeServingEngine, ServedFunction
from repro_torch.utils import get_logger

log = get_logger("serve")


def default_catalogue():
    def tiny(name, layers, d, ff_mult=2, family="dense", **kw):
        base = dict(name=name, family=family, n_layers=layers, d_model=d,
                    n_heads=4, n_kv_heads=2, head_dim=max(d // 4, 16),
                    d_ff=d * ff_mult, vocab_size=512,
                    param_dtype="float32", compute_dtype="float32",
                    attn_chunk=32)
        base.update(kw)
        return ModelConfig(**base)

    return [
        ServedFunction(0, tiny("edge-chat-s", 2, 64), prompt_len=16,
                       gen_tokens=4),
        ServedFunction(1, tiny("edge-chat-m", 4, 128), prompt_len=16,
                       gen_tokens=8),
        ServedFunction(2, tiny("edge-summarize", 2, 128), prompt_len=32,
                       gen_tokens=2),
        ServedFunction(3, tiny("edge-classify", 2, 64), prompt_len=16,
                       gen_tokens=1),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="esff")
    ap.add_argument("--capacity", type=int, default=2)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--straggler-factor", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    eng = EdgeServingEngine(default_catalogue(), capacity=args.capacity,
                            policy=args.policy,
                            straggler_factor=args.straggler_factor,
                            seed=args.seed, device=args.device)
    reqs = eng.make_requests(args.requests, args.duration, seed=args.seed)
    res = eng.run(reqs)
    print(json.dumps(res.summary(), indent=2))


if __name__ == "__main__":
    main()

"""Architecture registry of the port (counterpart of
`repro.configs.registry`).

The port's model runs the dense, moe (with or without MLA), ssm and
hybrid families, so ``ARCHS`` holds the JAX package's configs of those
families, copied field for field: the dense qwen3-4b and qwen3-14b
(qk-norm), qwen1.5-4b (qkv bias) and internlm2-20b; the moe
deepseek-moe-16b and deepseek-v3-671b (MLA, MTP); the ssm mamba2-780m;
the hybrid zamba2-2.7b; and
the paper's scenario config ``paper_edge`` (`EdgeServingConfig`, not a
model). Every other name the JAX package
registers raises NotImplementedError naming the ROADMAP item that
ports it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.utils.registry import Registry

ARCHS = Registry("architectures")

_ARCH_MODULES = ["internlm2_20b", "qwen3_14b", "qwen1_5_4b", "qwen3_4b",
                 "deepseek_moe_16b", "deepseek_v3_671b", "mamba2_780m",
                 "zamba2_2_7b",
                 "paper_edge"]

# names of the JAX package's registry that the port does not build yet
NOT_PORTED = {
    "whisper-tiny": "ROADMAP Queue 1, item 6.3 (enc-dec)",
    "internvl2-76b": "ROADMAP Queue 1, item 6.3 (VLM)",
}


def _load_all() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(name: str) -> ModelConfig:
    """The config registered under ``name``. NotImplementedError for an
    architecture of the JAX package not ported yet, KeyError (listing
    what exists) for an unknown name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: {NOT_PORTED[name]}")
    _load_all()
    return ARCHS[name]()

"""Config registry: one module per architecture, plain data copied from
``repro.configs``. ``get_config(arch, variant="full"|"smoke",
factorized=False, **overrides)`` returns a
:class:`repro_torch.models.common.ModelConfig`. Every architecture's config
loads; ``Model`` refuses the families this slice does not serve."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.core.factorized import FactorizationConfig
from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-34b": "yi_34b",
    "qwen1.5-4b": "qwen1_5_4b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "mamba2-370m": "mamba2_370m",
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, variant: str = "full", factorized: bool = False,
               **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = getattr(mod, variant)()
    if factorized:
        cfg = dataclasses.replace(
            cfg, factorization=FactorizationConfig(enabled=True))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg

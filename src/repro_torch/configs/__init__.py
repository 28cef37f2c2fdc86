"""Config registry: one module per architecture, plain data copied from
``repro.configs``. ``get_config(arch, variant="full"|"smoke",
factorized=False, **overrides)`` returns a
:class:`repro_torch.models.common.ModelConfig`. Every architecture's config
loads; ``Model`` refuses the families this slice does not serve."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

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

# (seq_len, global_batch, step kind): the dry run's cells
# (``launch/dryrun.py``, ``launch/steps.py::build_bundle``).
SHAPES: Dict[str, Dict] = {
    "train_4k": {"seq": 4096, "batch": 256, "step": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "step": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "step": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "step": "decode"},
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


def shapes_for(arch: str) -> List[str]:
    """The input-shape cells of ``arch``: ``long_500k`` only for the
    sub-quadratic families (full-attention archs skip it)."""
    cfg = get_config(arch, "full")
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out

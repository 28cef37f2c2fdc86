"""The system under test: the port's ``Engine`` built over the harness's
weights. This is the only module of the harness that imports the program
(``repro_torch``, from ``src/`` of the checkout).

Set-up is what a deployment does before it takes traffic: build the
kernels (only a checkout's first run compiles: ``build/kernels`` inside
the checkout), take the weights, derive the compressed streams where the
configuration serves them (``project_wd_leaves`` then
``Model.compress_params``), and build the engine.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import typing
from pathlib import Path
from typing import Dict

import torch

from bench.lib import arch

_SRC = Path(__file__).resolve().parents[2] / "src"


def _import_path() -> None:
    if str(_SRC) not in sys.path:
        sys.path.insert(0, str(_SRC))


def model_config(spec):
    """The program's ``ModelConfig`` for ``spec``: its architecture
    module's ``program_config``, each nested dict turned into the config
    type its field names."""
    _import_path()
    from repro_torch.models.common import ModelConfig
    return _typed(ModelConfig, arch.module_of(spec).program_config(spec))


def _typed(cls, values: Dict):
    """``cls(**values)``, a dict value turned into the dataclass its
    field's type names (``Optional[MoEConfig]``) and a list into a tuple
    where the field is one."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for name, v in values.items():
        kinds = typing.get_args(hints[name]) or (hints[name],)
        if isinstance(v, dict):
            v = _typed(next(k for k in kinds if dataclasses.is_dataclass(k)),
                       v)
        elif isinstance(v, list) and any(
                typing.get_origin(k) is tuple for k in kinds):
            v = tuple(v)
        kw[name] = v
    return cls(**kw)


def import_program() -> None:
    """Import the modules of the program that set-up and the window use."""
    _import_path()
    import repro_torch.kernels.build  # noqa: F401
    import repro_torch.models.transformer  # noqa: F401
    import repro_torch.serve  # noqa: F401


def build_kernels(device) -> Dict:
    """Compile the CUDA kernels that are not built yet (none on the CPU)."""
    if torch.device(device).type != "cuda":
        return {}
    _import_path()
    from repro_torch.kernels import build
    return build.build_all()


def build_engine(spec, tree: Dict, engine_kw: Dict, device):
    """The engine serving ``tree`` (consumed: the raw factorized leaves
    are freed once compressed)."""
    _import_path()
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    model = Model(model_config(spec), device=device)
    kw = dict(engine_kw)
    if spec.factorized:
        projected = project_wd_leaves(tree, model.cfg.factorization)
        tree.clear()
        model, cparams, stats = model.compress_params(
            projected, value_bits=spec.value_bits)
        del projected
        kw["weight_stream_bits"] = stats["weight_stream_bits"]
        params = cparams
    else:
        params = dict(tree)
        tree.clear()
    eng = Engine(model, params, config=EngineConfig(**kw))
    del params
    gc.collect()
    return eng


def request(rid: int, prompt, max_new: int):
    _import_path()
    from repro_torch.serve import Request
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)

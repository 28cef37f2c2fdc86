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

import gc
import sys
from pathlib import Path
from typing import Dict

import torch

from bench.lib.modelspec import ModelSpec

_SRC = Path(__file__).resolve().parents[2] / "src"


def _import_path() -> None:
    if str(_SRC) not in sys.path:
        sys.path.insert(0, str(_SRC))


def model_config(spec: ModelSpec):
    """The program's ``ModelConfig`` for ``spec``."""
    _import_path()
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.models.common import ModelConfig
    fac = FactorizationConfig(enabled=True, rank_ratio=spec.rank_ratio,
                              nnz_ratio=spec.nnz_ratio,
                              min_dim=spec.min_dim) \
        if spec.factorized else FactorizationConfig()
    return ModelConfig(
        name=spec.name, family="dense", n_layers=spec.layers, d_model=spec.d,
        n_heads=spec.heads, n_kv_heads=spec.kv_heads, d_head=spec.head_dim,
        d_ff=spec.d_ff, vocab_size=spec.vocab, qkv_bias=spec.qkv_bias,
        act=spec.act, norm=spec.norm, rope=True, rope_theta=spec.rope_theta,
        sliding_window=spec.window, factorization=fac,
        dtype=spec.compute_dtype, param_dtype=spec.param_dtype)


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


def build_engine(spec: ModelSpec, tree: Dict, engine_kw: Dict,
                 device):
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

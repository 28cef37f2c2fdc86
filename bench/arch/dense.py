"""The dense decoder stacks (qwen2.5, starcoder2): the architecture of a
configuration that names none (``bench/lib/arch.py``). Every layer is of
one kind, stacked over an L axis: attention with optional biases on q, k
and v and one sliding window, then a SwiGLU or GELU FFN, every linear
dense or T-REX factorized. The spec, the layout and the counts are
``bench/lib/modelspec.py``'s, ``bench/lib/weights.py``'s and
``bench/lib/counts.py``'s; the reference is ``bench/reference/decoder.py``.
"""
from __future__ import annotations

from typing import Dict

from bench.lib.counts import step_work
from bench.lib.modelspec import ModelSpec, spec_from_dict
from bench.lib.weights import leaf_specs

__all__ = ["spec_from_dict", "leaf_specs", "program_config", "step_work"]


def program_config(spec: ModelSpec) -> Dict:
    """The program's ``ModelConfig`` fields for ``spec``."""
    fac = {"enabled": True, "rank_ratio": spec.rank_ratio,
           "nnz_ratio": spec.nnz_ratio, "min_dim": spec.min_dim} \
        if spec.factorized else {}
    return {"name": spec.name, "family": "dense", "n_layers": spec.layers,
            "d_model": spec.d, "n_heads": spec.heads,
            "n_kv_heads": spec.kv_heads, "d_head": spec.head_dim,
            "d_ff": spec.d_ff, "vocab_size": spec.vocab,
            "qkv_bias": spec.qkv_bias, "act": spec.act, "norm": spec.norm,
            "rope": True, "rope_theta": spec.rope_theta,
            "sliding_window": spec.window, "factorization": fac,
            "dtype": spec.compute_dtype, "param_dtype": spec.param_dtype}

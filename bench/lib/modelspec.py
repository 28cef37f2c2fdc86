"""A configuration file of ``bench/configs/`` read into the plain numbers
that the weight maker, the counts and the plain reference share.

The file mirrors the model's published ``config.json`` keys at its top
level (``hidden_size``, ``num_hidden_layers``, ``rms_norm_eps`` or
``norm_epsilon``, ...) with the values as the benchmark runs them;
``reduced`` names the keys changed from the source and ``published`` their
published values. What the model's type implies and its ``config.json``
does not spell out (``qkv_bias``, ``norm_type``, ``head_dim``) sits under
``implied``.

This is the dense decoder's spec (``bench/arch/dense.py``); a
configuration may name another architecture (``bench/lib/arch.py``).
Nothing here imports the program: the harness turns a spec into the
program's ``ModelConfig`` in ``bench/lib/program.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["ModelSpec", "Linear", "load_spec", "spec_from_dict"]


@dataclasses.dataclass(frozen=True)
class Linear:
    """One linear of a layer: ``x (.., d_in) @ W (d_in, d_out)``; factorized
    as ``W_S (d_in, r)`` (the family's shared dictionary) times a per-layer
    ``W_D (r, d_out)`` with ``nnz`` non-zeros a column when ``r`` is set."""
    name: str          # the program's leaf name: wq, wk, wv, wo, w_up, ...
    group: str         # attn or ffn
    family: str        # dictionary family: attn_q, ffn_up, ...
    d_in: int
    d_out: int
    bias: bool
    r: Optional[int] = None
    nnz: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str             # swiglu or gelu (tanh approximation)
    norm: str            # rmsnorm or layernorm
    norm_eps: float
    qkv_bias: bool
    rope_theta: float
    window: Optional[int]  # sliding window (ring lanes), None for none
    param_dtype: str     # the dtype the weights are made in
    compute_dtype: str   # the dtype the program computes in
    factorized: bool
    rank_ratio: float
    nnz_ratio: float
    min_dim: int
    value_bits: int

    def rank_for(self, d_in: int, d_out: int) -> int:
        """The T-REX rank: 0.625 of the smaller side, rounded up to 128."""
        base = min(d_in, d_out)
        return max(128, int(math.ceil(int(self.rank_ratio * base) / 128))
                   * 128)

    def linears(self) -> List[Linear]:
        d, hd = self.d, self.head_dim
        shapes = [("wq", "attn", "attn_q", d, self.heads * hd, self.qkv_bias),
                  ("wk", "attn", "attn_k", d, self.kv_heads * hd,
                   self.qkv_bias),
                  ("wv", "attn", "attn_v", d, self.kv_heads * hd,
                   self.qkv_bias),
                  ("wo", "attn", "attn_o", self.heads * hd, d, False),
                  ("w_up", "ffn", "ffn_up", d, self.d_ff, False),
                  ("w_down", "ffn", "ffn_down", self.d_ff, d, False)]
        if self.act == "swiglu":
            shapes.append(("w_gate", "ffn", "ffn_gate", d, self.d_ff, False))
        out = []
        for name, group, fam, di, do, bias in shapes:
            if self.factorized and min(di, do) >= self.min_dim:
                r = self.rank_for(di, do)
                out.append(Linear(name, group, fam, di, do, bias, r,
                                  max(1, int(self.nnz_ratio * r))))
            else:
                out.append(Linear(name, group, fam, di, do, bias))
        return out


_ACT = {"silu": "swiglu", "gelu_pytorch_tanh": "gelu"}
_NORM = {"rms_norm": "rmsnorm", "layer_norm": "layernorm"}


def spec_from_dict(c: Dict) -> ModelSpec:
    c = {**c.get("implied", {}), **c}
    f = c.get("factorization") or {}
    window = c.get("sliding_window") \
        if c.get("use_sliding_window", True) else None
    return ModelSpec(
        name=c["name"], d=c["hidden_size"], layers=c["num_hidden_layers"],
        heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim",
                       c["hidden_size"] // c["num_attention_heads"]),
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        act=_ACT[c["hidden_act"]], norm=_NORM[c["norm_type"]],
        norm_eps=c["rms_norm_eps"] if "rms_norm_eps" in c
        else c["norm_epsilon"], qkv_bias=bool(c["qkv_bias"]),
        rope_theta=float(c["rope_theta"]), window=window,
        param_dtype=c["param_dtype"], compute_dtype=c["torch_dtype"],
        factorized=bool(f.get("enabled", False)),
        rank_ratio=f.get("rank_ratio", 0.625),
        nnz_ratio=f.get("nnz_ratio", 0.125), min_dim=f.get("min_dim", 256),
        value_bits=f.get("value_bits", 6))


def load_spec(path):
    """The spec of a configuration file, made by the architecture module it
    names (``bench/lib/arch.py``; this module's for none)."""
    from bench.lib import arch
    return arch.spec_from_dict(json.loads(Path(path).read_text()))

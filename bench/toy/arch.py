"""A toy architecture that the dense spec cannot express, brought by a
configuration's ``arch`` key (``bench/lib/arch.py``) for the harness's
tests (``bench/test_bench_arch.py``): routed experts through the program's
``MoEConfig`` (softmax router, top ``k``, SwiGLU experts; a capacity
factor of at least ``E / k`` lets no claim drop) in every layer, and a
stack of mixed layers, windowed (``sliding_attention``: ring lanes) and
full (``full_attention``: paged lanes) by the file's ``layer_types``, each
layer's leaves apart. Its plain reference is ``bench/toy/reference.py``.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Tuple

import numpy as np

from bench.lib import counts
from bench.lib.modelspec import Linear
from bench.lib.weights import Leaf

__all__ = ["ToySpec", "spec_from_dict", "leaf_specs", "program_config",
           "step_work"]

_KIND = {"sliding_attention": "local", "full_attention": "attn"}


@dataclasses.dataclass(frozen=True)
class ToySpec:
    name: str
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    experts: int
    top_k: int
    d_expert: int
    capacity_factor: float
    kinds: Tuple[str, ...]   # each layer's: local or attn
    window: int              # the local layers' window
    norm_eps: float
    rope_theta: float
    param_dtype: str
    compute_dtype: str
    factorized: bool = False


def spec_from_dict(c: Dict) -> ToySpec:
    if len(c["layer_types"]) != c["num_hidden_layers"]:
        raise ValueError("layer_types names each layer's kind")
    return ToySpec(
        name=c["name"], d=c["hidden_size"], layers=c["num_hidden_layers"],
        heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], vocab=c["vocab_size"],
        experts=c["num_local_experts"], top_k=c["num_experts_per_tok"],
        d_expert=c["moe_intermediate_size"],
        capacity_factor=c["capacity_factor"],
        kinds=tuple(_KIND[t] for t in c["layer_types"]),
        window=c["sliding_window"], norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), param_dtype=c["param_dtype"],
        compute_dtype=c["torch_dtype"])


def _attn_linears(s: ToySpec) -> List[Linear]:
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    return [Linear("wq", "attn", "attn_q", s.d, q, False),
            Linear("wk", "attn", "attn_k", s.d, kv, False),
            Linear("wv", "attn", "attn_v", s.d, kv, False),
            Linear("wo", "attn", "attn_o", q, s.d, False)]


def _expert_linears(s: ToySpec) -> List[Linear]:
    return [Linear("w_gate", "moe", "moe_gate", s.d, s.d_expert, False),
            Linear("w_up", "moe", "moe_up", s.d, s.d_expert, False),
            Linear("w_down", "moe", "moe_down", s.d_expert, s.d, False)]


def leaf_specs(s: ToySpec) -> List[Leaf]:
    """Every layer's leaves under ``layers/layer_XX`` (no L axis); the
    experts' matrices ``(E, d_in, d_out)``; the router ``(d, E)`` drawn
    ``N(0, 1/d)``, so the scores of a token's experts lie apart."""
    out: List[Leaf] = [(("embed", "tok"), (s.vocab, s.d), False, 0.0, 0.02)]
    for i in range(s.layers):
        base = ("layers", f"layer_{i:02d}")
        out.append((base + ("norm1", "scale"), (s.d,), False, 1.0, 0.05))
        for lin in _attn_linears(s):
            out.append((base + ("attn", lin.name, "w"), (lin.d_in, lin.d_out),
                        False, 0.0, lin.d_in ** -0.5))
        out.append((base + ("norm2", "scale"), (s.d,), False, 1.0, 0.05))
        out.append((base + ("moe", "router"), (s.d, s.experts), False, 0.0,
                    s.d ** -0.5))
        for lin in _expert_linears(s):
            out.append((base + ("moe", lin.name, "w"),
                        (s.experts, lin.d_in, lin.d_out), False, 0.0,
                        lin.d_in ** -0.5))
    out.append((("final_norm", "scale"), (s.d,), False, 1.0, 0.05))
    out.append((("lm_head", "w"), (s.d, s.vocab), False, 0.0, s.d ** -0.5))
    return out


def program_config(s: ToySpec) -> Dict:
    return {"name": s.name, "family": "moe", "n_layers": s.layers,
            "d_model": s.d, "n_heads": s.heads, "n_kv_heads": s.kv_heads,
            "d_head": s.head_dim, "d_ff": s.d_expert, "vocab_size": s.vocab,
            "act": "swiglu", "norm": "rmsnorm", "rope": True,
            "rope_theta": s.rope_theta, "layer_pattern": list(s.kinds),
            "local_window": s.window,
            "moe": {"n_experts": s.experts, "top_k": s.top_k,
                    "d_ff_expert": s.d_expert,
                    "capacity_factor": s.capacity_factor},
            "dtype": s.compute_dtype, "param_dtype": s.param_dtype}


def step_work(s: ToySpec, kind: str, lengths: np.ndarray,
              n_new: np.ndarray) -> Dict[str, float]:
    """As ``counts.step_work``, layer kind by layer kind: the attention
    linears over the ``m`` fresh tokens, the router, each token's ``k``
    experts (``m k`` rows; the weights of at most ``min(E, m k)`` experts
    read), the attention of each kind under its own window."""
    n_new = np.asarray(n_new, np.int64)
    lengths = np.asarray(lengths, np.int64)
    live = n_new > 0
    m = int(n_new[live].sum())
    rows = int(live.sum())
    router = Linear("router", "moe", "router", s.d, s.experts, False)
    lin_f = lin_b = 0.0
    for lin in _attn_linears(s) + [router]:
        lin_f += s.layers * counts.linear_flops(lin, m)
        lin_b += s.layers * counts.linear_bytes(lin, s, m)
    read = min(s.experts, m * s.top_k)
    for lin in _expert_linears(s):
        lin_f += s.layers * counts.linear_flops(lin, m * s.top_k)
        lin_b += s.layers * (counts.linear_bytes(lin, s, m * s.top_k) + max(
            read - 1, 0) * lin.d_in * lin.d_out * counts.ACT_BYTES)
    af = ab = 0.0
    for k in set(s.kinds):
        part = types.SimpleNamespace(
            heads=s.heads, kv_heads=s.kv_heads, head_dim=s.head_dim,
            window=s.window if k == "local" else None,
            layers=s.kinds.count(k))
        f, b = counts.decode_attn(part, lengths[live] + 1) \
            if kind == "decode" \
            else counts.mixed_attn(part, lengths[live], n_new[live])
        af, ab = af + f, ab + b
    head = counts.head_flops(s, rows)
    return {"m": m, "rows": rows, "linear_flops": lin_f,
            "linear_bytes": lin_b, "attn_flops": af, "attn_bytes": ab,
            "head_flops": head, "flops": lin_f + af + head}

"""Weights made from ``--seed`` on the device, in the layout the program
serves and in the dtype the configuration makes them in.

A leaf is stacked over the layers (an L axis first) or made whole: the
dense stacks' layers are stacked, a stack of mixed layers keeps each
layer's leaves apart (``layers/layer_XX/...``), and expert weights carry
an E axis in their shape. Every leaf, and every layer of a stacked leaf,
has a generator of its own, seeded from ``(seed, path, layer)``, so the
plain reference can make any one layer again after the program's copy is
freed, and gets the same numbers. The dense decoder's draws
(:func:`leaf_specs`): linear weights ``N(0, 1/d_in)``; factorized ``W_D``
``N(0, 1/r)`` and dictionaries ``N(0, 1/d_in)``; biases ``N(0,
0.02^2)``; norm scales ``1 + N(0, 0.05^2)``, LayerNorm biases ``N(0,
0.02^2)``; the token table ``N(0, 0.02^2)``; the head ``N(0, 1/d)``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Tuple

import torch

from bench.lib import arch
from bench.lib.modelspec import ModelSpec

__all__ = ["leaf_specs", "make_tree", "make_leaf", "layer_leaf"]

# (path, shape without the L axis, stacked over layers, mean, std)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], bool, float, float]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def leaf_specs(spec: ModelSpec) -> List[Leaf]:
    d = spec.d
    out: List[Leaf] = [(("embed", "tok"), (spec.vocab, d), False, 0.0, 0.02)]
    for norm in ("norm1", "norm2"):
        out.append((("layers", norm, "scale"), (d,), True, 1.0, 0.05))
        if spec.norm == "layernorm":
            out.append((("layers", norm, "bias"), (d,), True, 0.0, 0.02))
    for lin in spec.linears():
        base = ("layers", lin.group, lin.name)
        if lin.r is None:
            out.append((base + ("w",), (lin.d_in, lin.d_out), True, 0.0,
                        1.0 / math.sqrt(lin.d_in)))
        else:
            out.append((base + ("wd",), (lin.r, lin.d_out), True, 0.0,
                        1.0 / math.sqrt(lin.r)))
        if lin.bias:
            out.append((base + ("b",), (lin.d_out,), True, 0.0, 0.02))
    out.append((("final_norm", "scale"), (d,), False, 1.0, 0.05))
    if spec.norm == "layernorm":
        out.append((("final_norm", "bias"), (d,), False, 0.0, 0.02))
    out.append((("lm_head", "w"), (d, spec.vocab), False, 0.0,
                1.0 / math.sqrt(d)))
    seen = set()
    for lin in spec.linears():
        if lin.r is not None and lin.family not in seen:
            seen.add(lin.family)
            out.append((("dicts", lin.family), (lin.d_in, lin.r), False, 0.0,
                        1.0 / math.sqrt(lin.d_in)))
    return out


def _generator(seed: int, path, layer: Optional[int],
               device) -> torch.Generator:
    key = f"{int(seed)}/{'/'.join(path)}/{layer}".encode()
    s = int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
    return torch.Generator(device=device).manual_seed(s)


def _fill(t: torch.Tensor, g: torch.Generator, mean: float,
          std: float) -> torch.Tensor:
    return t.normal_(mean, std, generator=g)


def make_leaf(spec, seed: int, leaf: Leaf, device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole leaf (with its L axis when stacked)."""
    path, shape, stacked, mean, std = leaf
    dt = dtype or _dtype(spec.param_dtype)
    if not stacked:
        return _fill(torch.empty(shape, dtype=dt, device=device),
                     _generator(seed, path, None, device), mean, std)
    t = torch.empty((spec.layers,) + shape, dtype=dt, device=device)
    for i in range(spec.layers):
        _fill(t[i], _generator(seed, path, i, device), mean, std)
    return t


def layer_leaf(spec, seed: int, leaf: Leaf, layer: int, device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One layer of a stacked leaf, the same numbers as ``make_leaf``'s."""
    path, shape, stacked, mean, std = leaf
    if not stacked:
        raise ValueError(f"{'/'.join(path)} is not stacked over layers")
    t = torch.empty(shape, dtype=dtype or _dtype(spec.param_dtype),
                    device=device)
    return _fill(t, _generator(seed, path, layer, device), mean, std)


def make_tree(spec, seed: int, device) -> Dict:
    """The program's parameter tree, in the layout of the spec's
    architecture module (the dense decoder's: ``embed``, ``layers``,
    ``final_norm``, ``lm_head`` and, factorized, ``dicts``)."""
    tree: Dict = {}
    for leaf in arch.module_of(spec).leaf_specs(spec):
        node = tree
        for k in leaf[0][:-1]:
            node = node.setdefault(k, {})
        node[leaf[0][-1]] = make_leaf(spec, seed, leaf, device)
    return tree

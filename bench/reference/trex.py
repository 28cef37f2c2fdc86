"""The reference's own weights: the raw draws of ``bench/lib/weights.py``
made again from the seed, layer by layer, in float32, and, for a
factorized configuration, the values that T-REX compression serves,
worked out again from them (never taken from the program):

1. ``W_D``: each column keeps its ``nnz`` largest entries by magnitude;
   the kept values of a layer's matrix are quantized to ``value_bits``
   levels between their minimum ``m`` and maximum ``M``:
   ``q = round((v - m) / (M - m) * (2^bits - 1))`` (half to even), served
   as ``q / (2^bits - 1) * (M - m) + m``.
2. ``W_S`` (one dictionary per family, shared by the layers): 16-level
   non-uniform quantization by Lloyd's k-means over the scalar values,
   started at 16 evenly spaced quantiles (linear interpolation), sums in
   float64, at most 25 iterations, stopping when no center moves more than
   ``1e-7 + 1e-5 |c|``; each entry takes the nearest center (a value on a
   midpoint takes the lower one).

(The T-REX paper, cs.AR 2025, sections on DMM and SMM; the program's
``core/compression.py`` does the same on its side.)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.lib.weights import layer_leaf, leaf_specs, make_leaf

__all__ = ["Weights", "kmeans_lut", "served_wd"]


def _quantiles(flat: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    srt = torch.sort(flat).values
    n = flat.numel()
    virt = (n - 1) * qs
    lo = np.minimum(np.floor(virt), n - 1).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    g = torch.from_numpy(virt - np.floor(virt)).to(flat.device)
    a = srt[torch.from_numpy(lo).to(flat.device)].double()
    b = srt[torch.from_numpy(hi).to(flat.device)].double()
    d = b - a
    return torch.where(g >= 0.5, b - d * (1 - g), a + d * g).float()


def kmeans_lut(w: torch.Tensor, bits: int = 4, iters: int = 25):
    """``(codes, lut)`` of a dictionary: the 16 centers and each entry's."""
    flat = w.float().reshape(-1)
    k = 1 << bits
    centers = torch.unique(_quantiles(flat, np.linspace(0, 1, k + 2)[1:-1]))
    while centers.numel() < k:
        centers = torch.cat([centers, centers[-1:] + 1e-6])
    f64 = flat.double()
    for _ in range(iters):
        centers = torch.sort(centers).values
        idx = torch.bucketize(flat, (centers[1:] + centers[:-1]) / 2)
        sums = torch.zeros(k, dtype=torch.float64, device=flat.device)
        sums.index_add_(0, idx, f64)
        cnt = torch.bincount(idx, minlength=k)
        new = torch.where(cnt > 0, (sums / cnt.clamp(min=1)).float(),
                          centers)
        done = bool(((new - centers).abs()
                     <= 1e-7 + 1e-5 * centers.abs()).all())
        centers = new
        if done:
            break
    centers = torch.sort(centers).values
    codes = torch.bucketize(flat, (centers[1:] + centers[:-1]) / 2)
    return codes.reshape(w.shape), centers


def served_wd(wd: torch.Tensor, nnz: int, bits: int) -> torch.Tensor:
    """Dense ``(r, d_out)`` float32 of the values a compressed ``W_D``
    serves."""
    wd = wd.float()
    idx = torch.topk(wd.abs(), nnz, dim=0).indices
    vals = torch.gather(wd, 0, idx)
    m, M = vals.min(), vals.max()
    scale = (M.double() - m.double()).float()
    levels = float((1 << bits) - 1)
    if float(scale) > 0:
        q = torch.round((vals - m) / scale * levels).clamp(0, levels)
        vals = q / levels * scale + m
    else:
        vals = torch.full_like(vals, float(m))
    return torch.zeros_like(wd).scatter_(0, idx, vals)


class Weights:
    """Float32 weights of ``spec`` for seed ``seed`` on ``device``, one
    layer at a time."""

    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.leaves = {"/".join(p): (p, s, st, m, sd)
                       for p, s, st, m, sd in leaf_specs(spec)}
        self.lins = {lin.name: lin for lin in spec.linears()}
        self._dicts: Dict[str, torch.Tensor] = {}

    def _whole(self, path: str) -> torch.Tensor:
        return make_leaf(self.spec, self.seed, self.leaves[path],
                         self.device).float()

    def _layer(self, path: str, li: int) -> torch.Tensor:
        return layer_leaf(self.spec, self.seed, self.leaves[path], li,
                          self.device).float()

    def dictionary(self, family: str) -> torch.Tensor:
        if family not in self._dicts:
            codes, lut = kmeans_lut(self._whole(f"dicts/{family}"))
            self._dicts[family] = lut[codes]
        return self._dicts[family]

    def embed(self) -> torch.Tensor:
        return self._whole("embed/tok")

    def final_norm(self) -> Dict[str, torch.Tensor]:
        return {k.split("/")[-1]: self._whole(k) for k in self.leaves
                if k.startswith("final_norm/")}

    def head(self) -> torch.Tensor:
        return self._whole("lm_head/w")

    def layer(self, li: int) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for norm in ("norm1", "norm2"):
            out[norm] = {k.split("/")[-1]: self._layer(k, li)
                         for k in self.leaves
                         if k.startswith(f"layers/{norm}/")}
        for name, lin in self.lins.items():
            base = f"layers/{lin.group}/{name}"
            w: Dict[str, torch.Tensor] = {}
            if lin.r is None:
                w["w"] = self._layer(f"{base}/w", li)
            else:
                w["ws"] = self.dictionary(lin.family)
                w["wd"] = served_wd(self._layer(f"{base}/wd", li), lin.nnz,
                                    self.spec.value_bits)
            if lin.bias:
                w["b"] = self._layer(f"{base}/b", li)
            out[name] = w
        return out

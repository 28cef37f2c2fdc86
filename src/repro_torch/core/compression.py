"""T-REX compression pipeline (``repro.core.compression``) in torch.

The same three techniques as the reference, computed on the parameters'
device so that a full-width model compresses on the card:

1. ``W_S``: 16b -> 4b non-uniform quantization, a 16-entry codebook fit by
   Lloyd's k-means over the scalar weight distribution.
2. ``W_D`` indices: sorted row indices per column, delta-encoded.
3. ``W_D`` values: 6b uniform quantization with a per-layer scale
   ``(M - m)`` and offset ``m``.

The arithmetic follows the reference's numpy step for step: the quantile
init is numpy's "linear" interpolation written out (``torch.quantile``
refuses more than 2^24 elements), the k-means sums are taken in float64
(as ``np.bincount(weights=...)`` takes them), ``searchsorted`` takes the
left side, and the top-nnz rows of each column are sorted ascending.

The row reorder of the offline tooling (:func:`reorder_for_delta`, used by
``core/factorized.py::compress_linear``) is host-side numpy, as in the
reference; the serving path never runs it (``compress_model_params``
shares one W_S per family, which cannot take a per-layer row order).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

__all__ = [
    "NonUniformQuant",
    "UniformQuant",
    "CompressedWD",
    "CompressedWS",
    "quantize_nonuniform",
    "dequantize_nonuniform",
    "quantize_uniform",
    "dequantize_uniform",
    "delta_encode",
    "delta_decode",
    "bits_needed",
    "reorder_for_delta",
    "compress_ws",
    "compress_wd",
    "decompress_ws_dense",
    "decompress_wd_dense",
    "ws_compressed_bits",
    "wd_compressed_bits",
]


# --------------------------------------------------------------------------
# 1. Non-uniform (LUT / k-means) quantization for W_S
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NonUniformQuant:
    codes: torch.Tensor  # uint8, the source matrix's shape, values < 2**bits
    lut: torch.Tensor    # float32 (2**bits,), sorted ascending
    bits: int

    @property
    def shape(self):
        return tuple(self.codes.shape)


def _quantile_linear(flat: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    """``np.quantile(flat, qs).astype(np.float32)`` (method "linear"):
    virtual index ``(n - 1) q`` in float64, the two neighbours of the
    sorted f32 data, their f32 difference, and the lerp in float64 from the
    nearer end."""
    n = flat.numel()
    srt = torch.sort(flat).values
    virt = (n - 1) * qs
    prev = np.floor(virt)
    nxt = prev + 1
    top = virt >= n - 1
    prev[top] = n - 1
    nxt[top] = n - 1
    gamma = torch.from_numpy(virt - np.floor(virt)).to(flat.device)
    a = srt[torch.from_numpy(prev.astype(np.int64)).to(flat.device)]
    b = srt[torch.from_numpy(nxt.astype(np.int64)).to(flat.device)]
    diff = (b - a).double()
    lerp = torch.where(gamma >= 0.5, b.double() - diff * (1 - gamma),
                       a.double() + diff * gamma)
    return lerp.float()


def _sorted_edges(centers: torch.Tensor) -> torch.Tensor:
    return (centers[1:] + centers[:-1]) / 2


def quantize_nonuniform(w: torch.Tensor, bits: int = 4, iters: int = 25,
                        seed: int = 0) -> NonUniformQuant:
    """Lloyd's k-means over the scalar weight distribution, initialized at
    evenly spaced quantiles (deterministic). One host sync per iteration
    (the convergence test), as in the reference."""
    w = w.float()
    flat = w.reshape(-1)
    k = 1 << bits
    qs = np.linspace(0.0, 1.0, k + 2)[1:-1]
    centers = torch.unique(_quantile_linear(flat, qs))  # sorted
    while centers.numel() < k:  # pathological inits (constant matrices)
        centers = torch.cat([centers, centers[-1:] + 1e-6])
    flat64 = flat.double()
    for _ in range(iters):
        centers = torch.sort(centers).values
        assign = torch.searchsorted(_sorted_edges(centers), flat)
        sums = torch.bincount(assign, weights=flat64, minlength=k)
        counts = torch.bincount(assign, minlength=k)
        nonempty = counts > 0
        new_centers = torch.where(
            nonempty, (sums / counts.clamp(min=1)).float(), centers)
        # np.allclose(new, old, atol=1e-7) at its default rtol, in f32
        close = bool(((new_centers - centers).abs()
                      <= 1e-7 + 1e-5 * centers.abs()).all())
        centers = new_centers
        if close:
            break
    centers = torch.sort(centers).values
    codes = torch.searchsorted(_sorted_edges(centers), flat)
    return NonUniformQuant(codes=codes.to(torch.uint8).reshape(w.shape),
                           lut=centers, bits=bits)


def dequantize_nonuniform(codes: torch.Tensor,
                          lut: torch.Tensor) -> torch.Tensor:
    """Runtime LUT decompression (the DMM core's dequantizer)."""
    return lut[codes.long()]


# --------------------------------------------------------------------------
# 2. Uniform quantization with per-layer scale/offset for values of W_D
# --------------------------------------------------------------------------


@dataclasses.dataclass
class UniformQuant:
    q: torch.Tensor       # uint8 codes, values < 2**bits
    scale: torch.Tensor   # 0-d f32: (M - m), the full range of the values
    offset: torch.Tensor  # 0-d f32: m, their minimum
    bits: int


def quantize_uniform(v: torch.Tensor, bits: int = 6) -> UniformQuant:
    """Normalize with the layer's scale ``(M - m)`` and offset ``m``. The
    scale is ``M - m`` in float64 rounded to f32, and the codes are
    ``round((v - m) / scale * levels)`` in f32, half to even, as numpy
    computes them. No host sync: a constant input (scale 0) gives zero
    codes through ``where``."""
    v = v.float()
    levels = (1 << bits) - 1
    if v.numel() == 0:
        zero = torch.zeros((), dtype=torch.float32, device=v.device)
        return UniformQuant(q=torch.zeros(v.shape, dtype=torch.uint8,
                                          device=v.device),
                            scale=zero, offset=zero, bits=bits)
    m, M = v.min(), v.max()
    scale = (M.double() - m.double()).float()
    live = scale > 0
    q = torch.round((v - m) / torch.where(live, scale, 1.0) * levels)
    q = torch.where(live, q.clamp(0, levels), 0.0).to(torch.uint8)
    return UniformQuant(q=q, scale=torch.where(live, scale, 0.0), offset=m,
                        bits=bits)


def dequantize_uniform(q: torch.Tensor, scale, offset,
                       bits: Union[int, torch.Tensor] = 6) -> torch.Tensor:
    """Runtime dequantizer; ``bits`` may be a tensor (the serving path
    streams it with the codes), so the level count is ``exp2(bits) - 1``
    in f32, exact for any realistic width."""
    levels = torch.exp2(torch.as_tensor(bits, dtype=torch.float32,
                                        device=q.device)) - 1.0
    return q.float() / levels * scale + offset


# --------------------------------------------------------------------------
# 3. Delta encoding + row reordering for indices of W_D
# --------------------------------------------------------------------------


def bits_needed(x: int) -> int:
    return max(1, int(np.ceil(np.log2(x + 1))) if x > 0 else 1)


def delta_encode(indices: torch.Tensor) -> torch.Tensor:
    """Column-wise delta encoding of sorted ``(nnz, n_cols)`` indices: row
    0 keeps the absolute first index, rows 1.. the differences."""
    out = indices.clone()
    out[1:] = indices[1:] - indices[:-1]
    return out


def delta_decode(deltas: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(deltas, dim=0)


def reorder_for_delta(idx, r: int) -> np.ndarray:
    """Greedy co-occurrence order of the ``r`` rows of W_D (the paper's
    joint W_S column / W_D row rearrangement, so consecutive nonzero rows
    of a column lie close and their deltas fit 5 bits): start from the row
    in the most columns, then repeatedly take the unused row sharing the
    most columns with the last one taken, or, when none shares any, the
    unused row in the most columns. Ties go to the lowest row, as
    ``np.argmax`` takes them, so the order is the reference's element for
    element. ``idx`` (nnz, n_cols) (numpy or a tensor) holds each column's
    row indices.

    The occupancy is the reference's bitmap of 64-column words, built the
    same way: one fancy-indexed ``|=`` per rank ``k``, in which a row met
    twice within one word keeps only the last column's bit (numpy's
    buffered scatter), so the counts are those of that bitmap, not of the
    columns. The co-occurrence counts then come from one matrix product of
    its bits (exact in f32 below 2^24 columns), where the reference pops
    bits one row pair at a time. Returns ``order`` (int64) with ``wd_new
    = wd[order]`` and ``ws_new = ws[:, order]``."""
    idx = idx.cpu().numpy() if torch.is_tensor(idx) else np.asarray(idx)
    nnz, n_cols = idx.shape
    words = (n_cols + 63) // 64
    occ = np.zeros((r, words), np.uint64)
    cols = np.arange(n_cols)
    bit = np.uint64(1) << (cols % 64).astype(np.uint64)
    for k in range(nnz):
        occ[idx[k], cols // 64] |= bit
    bits = np.unpackbits(occ.view(np.uint8), axis=1).astype(np.float32)
    co = np.rint(bits @ bits.T).astype(np.int64)  # (r, r) shared bits
    freq = np.diag(co).copy()
    order = np.empty(r, np.int64)
    used = np.zeros(r, bool)
    cur = int(freq.argmax())
    order[0] = cur
    used[cur] = True
    for i in range(1, r):
        inter = co[cur].copy()
        inter[used] = -1
        nxt = int(inter.argmax())
        if inter[nxt] <= 0:  # no co-occurrence left: most frequent unused
            rem = np.where(~used)[0]
            nxt = int(rem[freq[rem].argmax()])
        order[i] = nxt
        used[nxt] = True
        cur = nxt
    return order


# --------------------------------------------------------------------------
# Compressed containers
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedWS:
    """Dictionary matrix, 4b non-uniform codes + LUT. Shape (d_in, r)."""

    codes: torch.Tensor  # uint8 (d_in, r)
    lut: torch.Tensor    # float32 (16,)
    bits: int

    @property
    def shape(self):
        return tuple(self.codes.shape)


@dataclasses.dataclass
class CompressedWD:
    """Per-layer sparse matrix in T-REX format: a fixed nnz per column,
    indices delta-encoded, values uniform-quantized."""

    deltas: torch.Tensor    # int32 (nnz, d_out): row 0 absolute, rest deltas
    values_q: torch.Tensor  # uint8 (nnz, d_out)
    scale: torch.Tensor     # 0-d f32
    offset: torch.Tensor    # 0-d f32
    value_bits: int
    r: int                  # rows of the dense W_D
    target_delta_bits: int = 5

    @property
    def nnz(self) -> int:
        return self.deltas.shape[0]

    @property
    def d_out(self) -> int:
        return self.deltas.shape[1]

    @property
    def achieved_delta_bits(self) -> int:
        if self.nnz <= 1:
            return 1
        return bits_needed(max(int(self.deltas[1:].max()), 0))

    @property
    def first_index_bits(self) -> int:
        return bits_needed(self.r - 1)


def compress_ws(ws: torch.Tensor, bits: int = 4) -> CompressedWS:
    q = quantize_nonuniform(ws, bits=bits)
    return CompressedWS(codes=q.codes, lut=q.lut, bits=bits)


def compress_wd(wd: torch.Tensor, nnz: int, value_bits: int = 6,
                order=None) -> CompressedWD:
    """Compress an (r, d_out) sparse-by-construction matrix: the top-nnz
    rows of each column by magnitude, sorted ascending, delta-encoded.
    ``order`` (from :func:`reorder_for_delta`) permutes the rows first;
    the caller permutes the W_S columns the same way."""
    wd = wd.float()
    if order is not None:
        wd = wd[torch.as_tensor(order, dtype=torch.long, device=wd.device)]
    r = wd.shape[0]
    keep = torch.topk(wd.abs(), nnz, dim=0).indices  # (nnz, d_out)
    idx = torch.sort(keep, dim=0).values
    vals = torch.gather(wd, 0, idx)
    uq = quantize_uniform(vals, bits=value_bits)
    return CompressedWD(deltas=delta_encode(idx).to(torch.int32),
                        values_q=uq.q, scale=uq.scale, offset=uq.offset,
                        value_bits=value_bits, r=r)


def decompress_ws_dense(cws: CompressedWS,
                        dtype=torch.float32) -> torch.Tensor:
    return dequantize_nonuniform(cws.codes, cws.lut).to(dtype)


def decompress_wd_dense(cwd: CompressedWD,
                        dtype=torch.float32) -> torch.Tensor:
    """Dense (r, d_out) reconstruction (duplicate indices add, as the
    reference's scatter-add), the plain oracle of the SMM kernel."""
    idx = delta_decode(cwd.deltas.long())  # (nnz, d_out)
    vals = dequantize_uniform(cwd.values_q, cwd.scale, cwd.offset,
                              cwd.value_bits)
    dense = torch.zeros((cwd.r, cwd.d_out), dtype=torch.float32,
                        device=vals.device)
    cols = torch.arange(cwd.d_out, device=vals.device).expand_as(idx)
    dense.index_put_((idx.reshape(-1), cols.reshape(-1)), vals.reshape(-1),
                     accumulate=True)
    return dense.to(dtype)


# --------------------------------------------------------------------------
# Size accounting
# --------------------------------------------------------------------------


def ws_compressed_bits(cws: CompressedWS) -> int:
    d_in, r = cws.shape
    return d_in * r * cws.bits + cws.lut.numel() * 16  # codes + 16b LUT


def wd_compressed_bits(cwd: CompressedWD,
                       use_achieved_delta_bits: bool = False) -> int:
    """Bits to stream one layer's W_D: per column one absolute first index,
    ``nnz - 1`` deltas and ``nnz`` values, plus 2 x 16b scale/offset.
    Deltas are priced at the nominal ``target_delta_bits`` or, with
    ``use_achieved_delta_bits``, at the width this stream needs (the
    serving accounting's mode)."""
    db = cwd.achieved_delta_bits if use_achieved_delta_bits \
        else cwd.target_delta_bits
    per_col = cwd.first_index_bits + (cwd.nnz - 1) * db \
        + cwd.nnz * cwd.value_bits
    return per_col * cwd.d_out + 2 * 16


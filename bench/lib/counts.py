"""Operations and bytes that a step's work needs, from the configuration's
shapes and each row's context; the yardstick of the rooflines and of the
model FLOP utilization.

Only useful work is counted: the rows that emit (decode rows) and the
fresh prompt tokens of chunk rows, never the padded columns or idle slots
that the program may compute besides. Attention over a windowed stack
(ring lanes) counts ``min(context, window)`` keys. A factorized linear's
``W_D`` product counts its non-zeros: ``2 M (K r + nnz N)``. Bytes count
each input read once and each output written once, at the width the
program stores it: bf16 activations and K/V, compressed streams as the
program keeps them (4-bit codes two to a byte, a 16-entry f32 LUT, per
column an int32 first index, ``nnz - 1`` one-byte deltas and ``nnz``
one-byte values, two f32 scalars a layer). (``launch/kernel_table.py``
bounds the DMM, SMM and TDA launches the same way.)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from bench.lib.modelspec import Linear, ModelSpec

__all__ = ["PEAKS", "keys_for", "linear_flops", "linear_bytes",
           "decode_attn", "mixed_attn", "head_flops",
           "step_work", "bound_s"]

PEAKS: Dict = json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text())

ACT_BYTES = 2  # bf16 activations, K and V


def keys_for(spec: ModelSpec, pos: np.ndarray) -> np.ndarray:
    """Keys a query at absolute position ``pos`` attends (itself included)."""
    k = np.asarray(pos, np.int64) + 1
    return np.minimum(k, spec.window) if spec.window else k


def linear_flops(lin: Linear, m: int) -> int:
    if lin.r is None:
        return 2 * m * lin.d_in * lin.d_out
    return 2 * m * (lin.d_in * lin.r + lin.nnz * lin.d_out)


def _weight_bytes(lin: Linear) -> int:
    if lin.r is None:
        return lin.d_in * lin.d_out * ACT_BYTES
    codes = lin.d_in * lin.r // 2 + 16 * 4
    wd = lin.d_out * (4 + (lin.nnz - 1) + lin.nnz) + 8
    return codes + wd


def linear_bytes(lin: Linear, spec: ModelSpec, m: int) -> int:
    """x read, the weights (or streams) read, y written; bias read."""
    b = _weight_bytes(lin) + m * (lin.d_in + lin.d_out) * ACT_BYTES
    return b + (lin.d_out * ACT_BYTES if lin.bias else 0)


def _kv_token_bytes(spec: ModelSpec) -> int:
    return 2 * spec.kv_heads * spec.head_dim * ACT_BYTES


def decode_attn(spec: ModelSpec, ctx: np.ndarray) -> Tuple[float, float]:
    """(FLOPs, bytes) of the decode attention over every layer for rows
    whose new token sits at position ``ctx - 1`` (``ctx`` keys with it):
    QK and PV, the lane's K and V read once, q read and o written."""
    keys = keys_for(spec, np.asarray(ctx, np.int64) - 1)
    hq = spec.heads * spec.head_dim
    flops = 4.0 * hq * float(keys.sum())
    byts = _kv_token_bytes(spec) * float(keys.sum()) \
        + 2.0 * hq * ACT_BYTES * len(keys)
    return spec.layers * flops, spec.layers * byts


def mixed_attn(spec: ModelSpec, start: np.ndarray,
               n_new: np.ndarray) -> Tuple[float, float]:
    """(FLOPs, bytes) of the mixed step's attention over every layer: row
    b's ``n_new[b]`` fresh tokens at ``[start[b], start[b] + n_new[b])``
    attend the resident lane and their causal chunk; the resident K/V
    (at most a window of it) is read once, the chunk's q, k, v read and
    its o written."""
    hq = spec.heads * spec.head_dim
    kvw = spec.kv_heads * spec.head_dim
    flops = byts = 0.0
    for s, c in zip(np.asarray(start, np.int64), np.asarray(n_new, np.int64)):
        if c <= 0:
            continue
        keys = keys_for(spec, np.arange(s, s + c))
        flops += 4.0 * hq * float(keys.sum())
        resident = min(int(s), spec.window) if spec.window else int(s)
        byts += _kv_token_bytes(spec) * resident \
            + c * (2 * hq + 2 * kvw) * ACT_BYTES
    return spec.layers * flops, spec.layers * byts


def head_flops(spec: ModelSpec, rows: int) -> float:
    return 2.0 * rows * spec.d * spec.vocab


def step_work(spec: ModelSpec, kind: str, lengths: np.ndarray,
              n_new: np.ndarray) -> Dict[str, float]:
    """One step's useful work. ``lengths``: tokens resident in each active
    row before the step; ``n_new``: fresh tokens of each active row (1 for
    decode rows). Returns FLOPs and bytes of the linears (all layers), of
    the attention (``attn_kind`` decode or mixed), of the head, and the
    token count ``m``."""
    n_new = np.asarray(n_new, np.int64)
    lengths = np.asarray(lengths, np.int64)
    live = n_new > 0
    m = int(n_new[live].sum())
    lin_f = lin_b = 0.0
    for lin in spec.linears():
        lin_f += spec.layers * linear_flops(lin, m)
        lin_b += spec.layers * linear_bytes(lin, spec, m)
    if kind == "decode":
        af, ab = decode_attn(spec, lengths[live] + 1)
    else:
        af, ab = mixed_attn(spec, lengths[live], n_new[live])
    rows = int(live.sum())
    return {"m": m, "rows": rows, "linear_flops": lin_f,
            "linear_bytes": lin_b, "attn_flops": af, "attn_bytes": ab,
            "head_flops": head_flops(spec, rows),
            "flops": lin_f + af + head_flops(spec, rows)}


def bound_s(flops: float, byts: float) -> float:
    """The least time the card could take: the larger of the FLOP bound
    at the bf16 peak and the byte bound at the HBM rate."""
    return max(flops / PEAKS["bf16_flops"], byts / PEAKS["hbm_bytes_s"])


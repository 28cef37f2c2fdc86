"""TDA attention kernels: wrappers over the hand-written CUDA kernels.

``tda_decode_attention``, ``tda_paged_decode_attention`` and
``tda_mixed_attention`` take the same arguments as the reference's Pallas
kernels (``repro.kernels.tda.tda``). On CUDA tensors they launch the
kernels built from ``kernels/csrc/`` (``tda_decode.cu``,
``tda_paged_decode.cu``, ``tda_mixed.cu``) on the current stream, or
raise: there is no fallback. On CPU tensors they run the kernels' plain
PyTorch versions of ``ref.py`` (over gathered lanes for the paged
kernels), which are also what the kernels are held against on the card.
All three take int8 pool or lane codes with f32 per-(token, head) scales,
dequantized inside the kernel (the mixed kernel's in-row chunk stays fp),
and an optional ``lut_table``: the AFU's 64-entry exp for both
exponentials of the online softmax, rescaled per reference block
(``block_k`` positions for contiguous lanes, one page for paged ones, the
row chunk as one more block in the mixed step).

The two decode kernels split each lane's key axis across blocks
(flash-decoding) as ``decode_split_plan`` says, and merge the splits'
partials in the same launch; the wrappers hand them a workspace
(``torch.empty``) and per-(slot, kv head) counters, zeroed once per device
and reset by the kernel itself after each merge. With a LUT table the plan
has one split per lane: the LUT result depends on the block order.

``VARIANT_LAUNCHES`` counts kernel launches by variant (``name``,
``name.int8``, ``name.lut``, ``name.int8.lut``) and ``LAUNCHES`` reads
them per kernel (the sum of its variants); plain-version calls are not
counted, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch

from repro_torch.kernels.afu.ref import LUT_SIZE
from repro_torch.kernels.common import merge_counters
from repro_torch.kernels.tda.ref import (
    decode_attention_lut,
    decode_attention_reference,
    mixed_attention_lut,
    mixed_attention_reference,
)

__all__ = ["tda_decode_attention", "tda_paged_decode_attention",
           "tda_mixed_attention", "decode_split_plan", "LAUNCHES",
           "VARIANT_LAUNCHES", "reset_launch_counts"]

_KERNELS = ("tda_decode_attention", "tda_paged_decode_attention",
            "tda_mixed_attention")
_VARIANTS = ("", ".int8", ".lut", ".int8.lut")
VARIANT_LAUNCHES = {name + suffix: 0 for name in _KERNELS
                    for suffix in _VARIANTS}


class _KernelLaunches(Mapping):
    """Launches per kernel, read from ``VARIANT_LAUNCHES`` (read-only)."""

    def __getitem__(self, name: str) -> int:
        if name not in _KERNELS:
            raise KeyError(name)
        return sum(VARIANT_LAUNCHES[name + s] for s in _VARIANTS)

    def __iter__(self):
        return iter(_KERNELS)

    def __len__(self) -> int:
        return len(_KERNELS)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = _KernelLaunches()
MAX_GROUP = 8     # query rows per kv head the decode kernels hold
MAX_HEAD_DIM = 128
MAX_LUT_BLOCK = 256  # positions a LUT-mode block may hold (score buffer)
SPLIT_BASE = 64   # positions of a decode split, page-aligned, at least
MAX_SPLITS = 128  # splits of one lane, at most (the kernel's kMaxSplits)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_split_plan(width: int, page_size: Optional[int] = None,
                      lut: bool = False) -> int:
    """Positions per split of the decode kernels' key axis over a lane of
    ``width`` positions: split ``i`` covers ``[i L, (i + 1) L)``, so
    ``ceil(width / L)`` splits cover each position once. ``SPLIT_BASE``
    positions, doubled while there would be more than ``MAX_SPLITS``; on
    paged lanes a divisor or a multiple of ``page_size`` (half a 128-token
    page; whole pages when pages are small), so a split reads one
    block-table entry per page. With a LUT table, one split (``L >=
    width``): the LUT exp's result depends on the reference's block order,
    which a merge of splits would not keep."""
    width = max(int(width), 1)
    if lut:
        return width
    L = SPLIT_BASE
    if page_size is not None:
        L = int(page_size)
        while L > SPLIT_BASE and L % 2 == 0:
            L //= 2
        L *= -(-SPLIT_BASE // L)
    while -(-width // L) > MAX_SPLITS:
        L *= 2
    return L


def _split_buffers(q, Hkv: int, width: int, split: int):
    """The split kernels' workspace (partials of every split: acc, then m
    and l) and counters, as pointers, and the workspace tensor; none with
    one split. The counters are shared by every launch on the device: the
    kernels run on one stream, in order, and leave them at 0."""
    B, Hq, D = q.shape
    nsplit = -(-max(width, 1) // split)
    if nsplit == 1:
        return 0, 0, None
    ws = torch.empty(nsplit * B * Hq * (D + 2), dtype=torch.float32,
                     device=q.device)
    cnt = merge_counters(q.device, B * Hkv)
    return ws.data_ptr(), cnt.data_ptr(), ws


def reset_launch_counts() -> None:
    for name in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[name] = 0


def _count(name: str, quant: int, table_ptr: int) -> None:
    VARIANT_LAUNCHES[name + (".int8" if quant else "")
                     + (".lut" if table_ptr else "")] += 1


def _gather(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    # Local import: ops imports this module for the wrappers.
    from repro_torch.kernels.tda.ops import gather_paged_lanes
    return gather_paged_lanes(pool, bt)


def _check(name: str, tensors, fp, ints) -> int:
    """Device / dtype / contiguity checks shared by the wrappers; returns
    the kernel's dtype code."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    dts = {t.dtype for t in fp}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPE_CODE:
        raise TypeError(f"{name}: q/k/v must share one dtype of "
                        f"{sorted(map(str, _DTYPE_CODE))}, got {dts}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: bounds and block_table must be int32")
    return _DTYPE_CODE[next(iter(dts))]


def _kv_inputs(name: str, q, k, v, k_scale, v_scale, ints, rows=()):
    """Checks for fp or int8 K/V: returns ``(dtype code, quant flag,
    k_scale pointer, v_scale pointer)``. int8 codes need contiguous f32
    scales shaped like the codes without their last axis; ``rows`` (the
    mixed step's chunk keys/values) are always in q's dtype."""
    quant = k_scale is not None or v_scale is not None
    if not quant:
        fp = (q, k, v) + tuple(rows)
        return _check(name, fp + ints, fp, ints), 0, 0, 0
    if k_scale is None or v_scale is None:
        raise ValueError(f"{name}: int8 lanes need both k_scale and v_scale")
    code = _check(name, (q, k, v, k_scale, v_scale) + tuple(rows) + ints,
                  (q,) + tuple(rows), ints)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{name}: with scales, k/v must be int8 codes, got "
                        f"{k.dtype}/{v.dtype}")
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or t.shape != k.shape[:-1]:
            raise TypeError(f"{name}: scales must be float32 of shape "
                            f"{tuple(k.shape[:-1])}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    return code, 1, k_scale.data_ptr(), v_scale.data_ptr()


def _table(name: str, table, q, block: int) -> int:
    """The LUT's pointer (0 without one): a contiguous (LUT_SIZE,) f32
    tensor on q's device, with LUT-mode blocks of at most MAX_LUT_BLOCK
    positions."""
    if table is None:
        return 0
    if table.device != q.device or table.dtype != torch.float32 \
            or tuple(table.shape) != (LUT_SIZE,) or not table.is_contiguous():
        raise TypeError(f"{name}: lut_table must be a contiguous float32 "
                        f"({LUT_SIZE},) tensor on {q.device}, got "
                        f"{table.dtype}{tuple(table.shape)} on {table.device}")
    if not 1 <= block <= MAX_LUT_BLOCK:
        raise ValueError(f"{name}: the LUT mode's blocks hold 1 to "
                         f"{MAX_LUT_BLOCK} positions, got {block}")
    return table.data_ptr()


def _heads(name: str, Hq: int, Hkv: int, D: int, max_group: int) -> None:
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} must be a multiple of Hkv={Hkv}")
    if Hq // Hkv > max_group or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: needs Hq/Hkv <= {max_group} and head "
                         f"dim <= {MAX_HEAD_DIM}, got G={Hq // Hkv}, D={D}")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _plain_decode(q, k, v, bounds, k_scale, v_scale, table,
                  block_k) -> torch.Tensor:
    """The decode kernels' plain version over (gathered) lanes: ``[lo,
    hi)`` attended, zeros where ``hi <= lo``; with a table, the LUT exp
    over blocks of ``block_k`` positions."""
    if table is not None:
        return decode_attention_lut(q, k, v, bounds, table, block_k, k_scale,
                                    v_scale)
    lo, hi = bounds[:, 0:1].long(), bounds[:, 1:2].long()
    out = decode_attention_reference(q, k, v, hi, k_scale=k_scale,
                                     v_scale=v_scale, window=hi - lo)
    return torch.where((hi > lo)[:, :, None], out, 0.0)


def tda_decode_attention(q, k, v, bounds, k_scale=None, v_scale=None,
                         lut_table=None, *, block_k: int = 128
                         ) -> torch.Tensor:
    """Slot-decode attention over contiguous lanes. q (B, Hq, D); k/v
    (B, S, Hkv, D) in q's dtype, or int8 codes with ``k_scale``/``v_scale``
    (B, S, Hkv) f32; bounds (B, 2) int32 ``[lo, hi)``, clamped to ``[0,
    S]`` (any S: the ragged tail needs no padding); ``lut_table`` the
    AFU's (64,) f32 exp table, with softmax blocks of ``min(block_k, S)``
    positions (``block_k`` changes nothing without a table). Returns (B,
    Hq, D) f32, zeros where ``hi <= lo``."""
    S = k.shape[1]
    bk = min(block_k, max(S, 1))
    if q.device.type == "cpu":
        return _plain_decode(q, k, v, bounds, k_scale, v_scale, lut_table,
                             bk)
    name = "tda_decode_attention"
    code, quant, ksp, vsp = _kv_inputs(name, q, k, v, k_scale, v_scale,
                                       (bounds,))
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or bounds.shape != (B, 2):
        raise ValueError(f"{name}: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} bounds"
                         f"{tuple(bounds.shape)}")
    _heads(name, Hq, Hkv, D, MAX_GROUP)
    tp = _table(name, lut_table, q, bk)
    split = decode_split_plan(S, lut=bool(tp))
    wsp, cntp, ws = _split_buffers(q, Hkv, S, split)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    from repro_torch.kernels.build import load
    fn = load("tda_decode").tda_decode
    _raise_on(name, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                       bounds.data_ptr(), tp, wsp, cntp, out.data_ptr(), B,
                       Hq, Hkv, D, S, bk, split, code, quant,
                       1.0 / math.sqrt(D),
                       torch.cuda.current_stream(q.device).cuda_stream))
    del ws  # held through the launch; frees stream-ordered after it
    _count(name, quant, tp)
    return out


def tda_paged_decode_attention(q, k, v, bounds, block_table, k_scale=None,
                               v_scale=None, lut_table=None) -> torch.Tensor:
    """Paged slot-decode attention. q (B, Hq, D); k/v page pools (P,
    page_size, Hkv, D) in q's dtype, or int8 codes with ``k_scale`` /
    ``v_scale`` pools (P, page_size, Hkv) f32 read through the same block
    table; bounds (B, 2) int32 ``[lo, hi)`` in logical lane coordinates;
    block_table (B, n) int32 (entries are clamped to ``[0, P-1]``; those
    outside ``[lo, hi)`` are never read); ``lut_table`` the AFU's exp
    table, one page per softmax block. Returns (B, Hq, D) f32, zeros where
    ``hi <= lo``."""
    ps = k.shape[1]
    if q.device.type == "cpu":
        lanes = [None if t is None else _gather(t, block_table)
                 for t in (k, v, k_scale, v_scale)]
        return _plain_decode(q, lanes[0], lanes[1], bounds, lanes[2],
                             lanes[3], lut_table, ps)
    name = "tda_paged_decode_attention"
    code, quant, ksp, vsp = _kv_inputs(name, q, k, v, k_scale, v_scale,
                                       (bounds, block_table))
    B, Hq, D = q.shape
    P, Hkv = k.shape[0], k.shape[2]
    if k.shape != v.shape or k.shape[3] != D or bounds.shape != (B, 2) \
            or block_table.shape[0] != B:
        raise ValueError(f"{name}: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} bounds"
                         f"{tuple(bounds.shape)} bt{tuple(block_table.shape)}")
    _heads(name, Hq, Hkv, D, MAX_GROUP)
    tp = _table(name, lut_table, q, ps)
    nblk = block_table.shape[1]
    split = decode_split_plan(nblk * ps, ps, lut=bool(tp))
    wsp, cntp, ws = _split_buffers(q, Hkv, nblk * ps, split)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    from repro_torch.kernels.build import load
    fn = load("tda_paged_decode").tda_paged_decode
    _raise_on(name, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                       bounds.data_ptr(), block_table.data_ptr(), tp, wsp,
                       cntp, out.data_ptr(), B, Hq, Hkv, D, P, ps, nblk,
                       split, code, quant, 1.0 / math.sqrt(D),
                       torch.cuda.current_stream(q.device).cuda_stream))
    del ws  # held through the launch; frees stream-ordered after it
    _count(name, quant, tp)
    return out


def tda_mixed_attention(q, k, v, k_row, v_row, bounds, block_table,
                        k_scale=None, v_scale=None, lut_table=None, *,
                        ring: int, window: Optional[int] = None
                        ) -> torch.Tensor:
    """Mixed-step attention over a paged pool. q (B, S, Hq, D); k/v page
    pools (P, page_size, Hkv, D) in q's dtype, or int8 codes with
    ``k_scale``/``v_scale`` pools (P, page_size, Hkv) f32 read through the
    same block table; k_row/v_row (B, S, Hkv, D) in q's dtype; bounds (B,
    2) int32 ``[cache_index, n_new]``; block_table (B, n) int32; ``ring``
    the logical lane width; ``lut_table`` the AFU's exp table (softmax
    blocks: each page, then the row chunk; page_size and S <= 256).
    Returns (B, S, Hq, D) f32; rows with no key (``ci == 0`` and ``n_new
    == 0``) are zeros. Columns ``j >= n_new`` are never read by the
    caller: the kernel writes them as zeros (so the projections after
    attention see finite values), the CPU path leaves the plain version's
    values there."""
    if ring < 1:
        raise ValueError(f"tda_mixed_attention: ring must be >= 1, got {ring}")
    ps = k.shape[1]
    if q.device.type == "cpu":
        lanes = [None if t is None else _gather(t, block_table)
                 for t in (k, v, k_scale, v_scale)]
        if lut_table is not None:
            return mixed_attention_lut(
                q, lanes[0], lanes[1], k_row, v_row, bounds[:, 0],
                bounds[:, 1], page_size=ps, ring=ring, window=window,
                table=lut_table, k_scale=lanes[2], v_scale=lanes[3])
        return mixed_attention_reference(
            q, lanes[0], lanes[1], k_row, v_row, bounds[:, 0], bounds[:, 1],
            ring=ring, window=window, k_scale=lanes[2], v_scale=lanes[3])
    name = "tda_mixed_attention"
    code, quant, ksp, vsp = _kv_inputs(name, q, k, v, k_scale, v_scale,
                                       (bounds, block_table), (k_row, v_row))
    B, S, Hq, D = q.shape
    P, Hkv = k.shape[0], k.shape[2]
    if k.shape != v.shape or k.shape[3] != D \
            or k_row.shape != (B, S, Hkv, D) or v_row.shape != k_row.shape \
            or bounds.shape != (B, 2) or block_table.shape[0] != B:
        raise ValueError(f"{name}: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} k_row{tuple(k_row.shape)} "
                         f"bounds{tuple(bounds.shape)} "
                         f"bt{tuple(block_table.shape)}")
    _heads(name, Hq, Hkv, D, Hq)
    tp = _table(name, lut_table, q, max(ps, S))
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    from repro_torch.kernels.build import load
    fn = load("tda_mixed").tda_mixed
    _raise_on(name, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                       k_row.data_ptr(), v_row.data_ptr(), bounds.data_ptr(),
                       block_table.data_ptr(), tp, out.data_ptr(), B, S, Hq,
                       Hkv, D, P, ps, block_table.shape[1], ring,
                       0 if window is None else int(window), code, quant,
                       1.0 / math.sqrt(D),
                       torch.cuda.current_stream(q.device).cuda_stream))
    _count(name, quant, tp)
    return out

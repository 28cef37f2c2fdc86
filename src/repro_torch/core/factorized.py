"""Factorized linear layers (``repro.core.factorized``): ``W = W_S @ W_D``.

Every weight matrix ``W (d_in, d_out)`` may be replaced by a dictionary
``W_S (d_in, r)``, shared by all layers of one matrix *family* (``attn_q``,
``ffn_up``, ...), times a per-layer sparse ``W_D (r, d_out)`` with a fixed
number of non-zeros per column, computed in the paper's order ``(x @ W_S)
@ W_D``. The parameter tree is the reference's: dictionaries under
``params["dicts"][family]``, per-layer factors ``{"wd": (L, r, d_out)}``
in the layer subtree, biases never factorized.

:func:`compress_model_params` turns that tree into the T-REX streaming
format (nibble-packed 4b W_S codes + LUT; delta-coded W_D indices with 6b
values), and :func:`apply_linear` dispatches on the keys present — dense
``w``, factorized ``wd`` or compressed ``wd_vq`` — so all three share the
model code. On a CUDA device the compressed branch runs the hand-written
DMM and SMM kernels (``kernels/dmm``, ``kernels/smm``); on the CPU it
decompresses and multiplies, as the reference does off the TPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.core import compression as comp
from repro_torch.core import sparsity
from repro_torch.kernels.dmm.ref import unpack_nibbles
from repro_torch.kernels.smm.ref import densify

__all__ = [
    "FactorizationConfig",
    "DictionaryBank",
    "init_linear",
    "apply_linear",
    "pack_nibbles",
    "unpack_nibbles",
    "decompress_ws_entry",
    "decompress_wd_leaf",
    "apply_compressed_linear",
    "params_stream_bits",
    "project_wd_leaves",
    "compress_model_params",
]

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FactorizationConfig:
    """Same fields and defaults as the reference's switch for the T-REX
    shared-dictionary factorization."""

    enabled: bool = False
    rank_ratio: float = 0.625
    rank: Optional[int] = None
    nnz_ratio: float = 0.125
    nnz: Optional[int] = None
    min_dim: int = 256
    reg_coeff: float = 1e-4
    ste_in_forward: bool = True

    def rank_for(self, d_in: int, d_out: Optional[int] = None) -> int:
        if self.rank is not None:
            return self.rank
        base = d_in if d_out is None else min(d_in, d_out)
        return max(128, _round_up(int(self.rank_ratio * base), 128))

    def nnz_for(self, r: int) -> int:
        if self.nnz is not None:
            return min(self.nnz, r)
        return max(1, int(self.nnz_ratio * r))

    def applies_to(self, d_in: int, d_out: int) -> bool:
        return self.enabled and min(d_in, d_out) >= self.min_dim


def _normal(g: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=g.device).normal_(
        0.0, std, generator=g)


class DictionaryBank:
    """Init-time registry of the shared W_S dictionaries, keyed by family.
    The first ``ensure`` of a family draws its ``(d_in, r)`` dictionary
    ``N(0, 1/d_in)``; later calls check the shape. ``dicts`` becomes
    ``params["dicts"]``."""

    def __init__(self, fcfg: FactorizationConfig, dtype=torch.float32):
        self.fcfg = fcfg
        self.dtype = dtype
        self.dicts: Dict[str, torch.Tensor] = {}

    def ensure(self, g: torch.Generator, family: str, d_in: int,
               d_out: Optional[int] = None) -> int:
        r = self.fcfg.rank_for(d_in, d_out)
        if family not in self.dicts:
            self.dicts[family] = _normal(g, (d_in, r), 1.0 / math.sqrt(d_in),
                                         self.dtype)
        elif tuple(self.dicts[family].shape) != (d_in, r):
            raise ValueError(f"dictionary {family!r} shape "
                             f"{tuple(self.dicts[family].shape)} != "
                             f"requested {(d_in, r)}")
        return r


def init_linear(g: torch.Generator, d_in: int, d_out: int,
                fcfg: FactorizationConfig, bank: Optional[DictionaryBank],
                family: str, use_bias: bool = False, dtype=torch.float32,
                lead=()) -> Dict[str, torch.Tensor]:
    """One linear layer's per-layer params, with leading dims ``lead``
    (``(L,)`` for a layer stack): factorized ``wd ~ N(0, 1/r)`` through
    the family dictionary where the factorization applies, else dense
    ``w ~ N(0, 1/d_in)``; zero bias."""
    lead = tuple(lead)
    p: Dict[str, torch.Tensor] = {}
    if fcfg.applies_to(d_in, d_out) and bank is not None:
        r = bank.ensure(g, family, d_in, d_out)
        p["wd"] = _normal(g, lead + (r, d_out), 1.0 / math.sqrt(r), dtype)
    else:
        p["w"] = _normal(g, lead + (d_in, d_out), 1.0 / math.sqrt(d_in),
                         dtype)
    if use_bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=g.device)
    return p


def apply_linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 dicts: Optional[Dict] = None, family: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ W (+ b)``, dispatching on the keys of ``p``: compressed
    streams (``wd_vq``), dense ``w``, or factorized ``wd`` through
    ``dicts[family]``.

    Dense and factorized weights are used in ``x``'s (the compute) dtype;
    ``Model.prepare`` makes that copy once at load time, so on the serving
    path the ``.to`` below is a no-op. At float32 this is the reference's
    arithmetic exactly. At bf16 compute over f32 params the reference
    promotes to an f32 product instead; the port multiplies in bf16, as
    the reference's compressed branch does."""
    if "wd_vq" in p:
        return apply_compressed_linear(
            p, x, dicts, family,
            compute_dtype=compute_dtype if compute_dtype is not None
            else x.dtype)
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
    else:
        # Sequential MM — (X @ W_S) @ W_D, the paper's compute order.
        y = (x @ dicts[family].to(x.dtype)) @ p["wd"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# --------------------------------------------------------------------------
# Compressed runtime representation (serve path)
# --------------------------------------------------------------------------


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4b codes two per byte along the leading axis (row 2i in the high
    nibble). An odd leading axis gets one zero-code pad row; consumers crop
    it (the DMM kernel reads ``x`` only for ``k < K``)."""
    codes = codes.to(torch.uint8)
    if codes.shape[0] % 2:
        codes = torch.cat([codes, codes.new_zeros((1,) + codes.shape[1:])])
    return (codes[0::2] << 4) | codes[1::2]


def decompress_ws_entry(entry, d_in: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Dense (d_in, r) W_S from a ``cdicts`` entry: a raw tensor or a
    ``{"codes_packed", "lut"}`` dict (the odd-``d_in`` pad row cropped)."""
    if isinstance(entry, dict):
        ws = comp.dequantize_nonuniform(unpack_nibbles(entry["codes_packed"]),
                                        entry["lut"])
        return ws[:d_in].to(dtype)
    return entry.to(dtype)


def decompress_wd_leaf(p: Dict[str, torch.Tensor], r: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Dense (r, d_out) W_D from one layer's streams (``wd_first``,
    ``wd_deltas``, ``wd_vq``, ``wd_scale``, ``wd_offset``, ``wd_bits``):
    the SMM kernel's plain densify (out-of-range indices dropped,
    duplicates added)."""
    return densify(p["wd_first"], p["wd_deltas"], p["wd_vq"], p["wd_scale"],
                   p["wd_offset"], r, p.get("wd_bits", 6)).to(dtype)


def apply_compressed_linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
                            cdicts: Dict, family: str,
                            compute_dtype=torch.bfloat16,
                            use_kernel: Optional[bool] = None
                            ) -> torch.Tensor:
    """Decompress-and-multiply over the T-REX streams.

    ``use_kernel=None`` takes the kernel route on a CUDA ``x`` (HBM weight
    traffic is the compressed bytes; no dense W_S or W_D is ever written)
    and the explicit decompression followed by two plain products on the
    CPU, as the reference picks its Pallas kernels on a TPU only. On the
    kernel route a ``{"codes_packed", "lut"}`` dictionary goes through the
    DMM wrapper and a raw W_S through a dense product; W_D always goes
    through the SMM wrapper. ``use_kernel=True`` on the CPU runs the
    wrappers' plain versions; only ``use_kernel=False`` decompresses on the
    card."""
    if "w" in p:
        y = x @ p["w"].to(compute_dtype)
    else:
        cd = cdicts[family]
        d_in = x.shape[-1]
        if use_kernel is None:
            use_kernel = x.device.type == "cuda"
        if use_kernel:
            from repro_torch.kernels.dmm.ops import lut_matmul
            from repro_torch.kernels.smm.ops import compressed_matmul
            lead = x.shape[:-1]
            x2 = x.reshape(-1, d_in)
            if isinstance(cd, dict):
                y1 = lut_matmul(x2, cd["codes_packed"], cd["lut"])  # (M, r)
            else:  # an uncompressed W_S: nothing for the DMM to decode
                y1 = (x2 @ cd.to(compute_dtype)).float()
            z = compressed_matmul(y1, p["wd_first"], p["wd_deltas"],
                                  p["wd_vq"], p["wd_scale"], p["wd_offset"],
                                  value_bits=p.get("wd_bits", 6))
            y = z.reshape(lead + (z.shape[-1],)).to(compute_dtype)
        else:
            ws = decompress_ws_entry(cd, d_in, compute_dtype)
            dense = decompress_wd_leaf(p, ws.shape[1], compute_dtype)
            y = (x @ ws) @ dense
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# --------------------------------------------------------------------------
# Whole-model compression + stream-bits accounting
# --------------------------------------------------------------------------


def _leaf_bits(a: torch.Tensor) -> int:
    return a.numel() * a.element_size() * 8


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_stream_bits(params) -> int:
    """Bits streamed per decode step if every weight leaf is read once at
    its in-memory width — the fallback when no audited accounting (from
    :func:`compress_model_params`) is given."""
    return sum(_leaf_bits(t) for t in _leaves(params))


def project_wd_leaves(params, fcfg: FactorizationConfig):
    """End-of-training projection: every ``wd`` leaf (any leading dims)
    snapped to its top-nnz column support, so the offline compression is
    exact on the indices. Returns a new tree; other leaves are shared."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "wd" and not isinstance(v, dict):
                r, d_out = v.shape[-2], v.shape[-1]
                nnz = fcfg.nnz_for(r)
                flat = v.reshape(-1, r, d_out)
                out[k] = torch.stack([
                    sparsity.project_topk_columns(w, nnz) for w in flat
                ]).reshape(v.shape)
            else:
                out[k] = walk(v)
        return out
    return walk(params)


def compress_model_params(params, fcfg: FactorizationConfig,
                          value_bits: int = 6):
    """Factorized param tree -> T-REX streaming tree, on the params' device.

    * ``params["dicts"]``: each family dictionary becomes ``{"codes_packed",
      "lut"}`` (4b codes nibble-packed along d_in, f32 LUT).
    * Every ``{"wd": (..., r, d_out)}`` group becomes the ``wd_first``
      (int32), ``wd_deltas`` (uint8, or int16 when any slice needs more
      than 8 bits), ``wd_vq`` (uint8), ``wd_scale``/``wd_offset`` (f32)
      and ``wd_bits`` (int32) streams with the same leading dims.
    * Everything else passes through.

    No reorder pass runs (a family-shared W_S cannot take a per-layer row
    order), so deltas are priced at their achieved width. Returns
    ``(cparams, stats)`` with the reference's integer ``weight_stream_bits``
    (compressed) and ``weight_stream_bits_dense`` (same tree uncompressed),
    their ratio and ``value_bits``."""
    if not isinstance(params, dict) or "dicts" not in params:
        raise ValueError("compress_model_params needs a factorized param tree "
                         "(params['dicts'] missing — init the model with "
                         "factorization.enabled=True)")
    bits = {"c": 0, "d": 0}

    cdicts = {}
    for fam, ws in params["dicts"].items():
        cws = comp.compress_ws(ws)
        cdicts[fam] = {"codes_packed": pack_nibbles(cws.codes),
                       "lut": cws.lut}
        bits["c"] += comp.ws_compressed_bits(cws)
        bits["d"] += _leaf_bits(ws)

    def compress_group(d: Dict) -> Dict:
        wd = d["wd"]
        lead, (r, d_out) = tuple(wd.shape[:-2]), tuple(wd.shape[-2:])
        nnz = fcfg.nnz_for(r)
        parts = [comp.compress_wd(w2, nnz, value_bits=value_bits)
                 for w2 in wd.reshape(-1, r, d_out)]
        bits["c"] += sum(comp.wd_compressed_bits(
            c, use_achieved_delta_bits=True) for c in parts)
        bits["d"] += _leaf_bits(wd)
        ddt = torch.uint8 if max(c.achieved_delta_bits for c in parts) <= 8 \
            else torch.int16

        def stack(f):
            ts = [f(c) for c in parts]
            return torch.stack(ts).reshape(lead + tuple(ts[0].shape))

        out = {
            "wd_first": stack(lambda c: c.deltas[0]),
            "wd_deltas": stack(lambda c: c.deltas[1:].to(ddt)),
            "wd_vq": stack(lambda c: c.values_q),
            "wd_scale": stack(lambda c: c.scale),
            "wd_offset": stack(lambda c: c.offset),
            "wd_bits": stack(lambda c: torch.tensor(
                c.value_bits, dtype=torch.int32, device=wd.device)),
        }
        for k, v in d.items():  # passthrough (biases)
            if k != "wd":
                out[k] = v
                bits["c"] += _leaf_bits(v)
                bits["d"] += _leaf_bits(v)
        return out

    def walk(node):
        if isinstance(node, dict):
            if "wd" in node:
                return compress_group(node)
            return {k: walk(v) for k, v in node.items()}
        bits["c"] += _leaf_bits(node)
        bits["d"] += _leaf_bits(node)
        return node

    cparams = {k: (cdicts if k == "dicts" else walk(v))
               for k, v in params.items()}
    stats = {
        "weight_stream_bits": int(bits["c"]),
        "weight_stream_bits_dense": int(bits["d"]),
        "weight_compression_ratio": bits["d"] / max(bits["c"], 1),
        "value_bits": value_bits,
    }
    return cparams, stats

"""The kernel tables: the reference's ``kernels`` and ``decode_attn``
benchmark tables (``benchmarks/tables.py``) on the port's kernels.

  PYTHONPATH=src python -m repro_torch.launch.kernel_table \\
      [kernels] [decode_attn] [--device cpu] [--out DIR]

Same shapes, the same ``numpy.random.default_rng(0)`` inputs and the same
row names as the reference: ``kernels/dmm_lut_matmul``,
``kernels/smm_compressed_matmul`` and ``kernels/afu_softmax_lut`` (the DMM,
SMM and AFU softmax kernels, with their weight-byte and LUT-error figures),
then ``decode_attn/fused``, ``/dense`` and ``/blocks`` (the int8 contiguous
decode kernel against the dense oracle, and the blocks-visited ratio).
Prints the CSV ``name,us_per_call,derived`` to stdout; only with ``--out``
does it write a JSON sidecar per table (``DIR/BENCH_<table>.json``), never
into the working directory. Runs on the CUDA device unless ``--device cpu``
is given; on the card each call is timed with CUDA events after a warm-up
(mean of 5 calls, the reference's count), on the CPU with the host clock.
``run`` also returns, per kernel row, the kernel's output (its warm-up
call's) beside its plain version's on the same inputs (``Table.outputs``),
for holding each kernel against its plain version on the card.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

Row = Tuple[str, float, str]
TABLES = ("kernels", "decode_attn")


class Table(NamedTuple):
    rows: List[Row]
    metrics: Dict
    # {row name: (kernel output, plain version's output)}, same inputs
    outputs: Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def time_us(fn: Callable, device: torch.device,
            n: int = 5) -> Tuple[float, torch.Tensor]:
    """Mean microseconds per call after one warm-up call, and the warm-up
    call's output."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / n * 1e3, out
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6, out


def bench_kernels(device: torch.device) -> Table:
    from repro_torch.core import compression as comp
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels import compressed_matmul, fused_softmax
    from repro_torch.kernels import lut_matmul

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(0)
    rows, outputs = [], {}
    M, K, r, N, nnz = 128, 512, 320, 512, 40
    ws = rng.normal(size=(K, r)).astype(np.float32) * 0.1
    cws = comp.compress_ws(T(ws))
    packed = pack_nibbles(cws.codes)
    x = T(rng.normal(size=(M, K)).astype(np.float32))
    us, out = time_us(lambda: lut_matmul(x, packed, cws.lut), device)
    outputs["kernels/dmm_lut_matmul"] = (
        out, lut_matmul(x, packed, cws.lut, use_kernel=False))
    dense_bytes = K * r * 2
    comp_bytes = K * r // 2 + 64
    rows.append(("kernels/dmm_lut_matmul", us,
                 f"weight_bytes {dense_bytes}->{comp_bytes} "
                 f"({dense_bytes / comp_bytes:.1f}x less HBM)"))

    wd = rng.normal(size=(r, N)).astype(np.float32)
    cwd = comp.compress_wd(T(wd), nnz)
    first = comp.delta_decode(cwd.deltas)[0].to(torch.int32)
    deltas = cwd.deltas[1:].to(torch.uint8)
    y = T(rng.normal(size=(M, r)).astype(np.float32))
    smm_args = (y, first, deltas, cwd.values_q, cwd.scale, cwd.offset)
    us, out = time_us(lambda: compressed_matmul(*smm_args), device)
    outputs["kernels/smm_compressed_matmul"] = (
        out, compressed_matmul(*smm_args, use_kernel=False))
    dense_bytes = r * N * 2
    stream_bytes = (comp.wd_compressed_bits(cwd) + 7) // 8
    rows.append(("kernels/smm_compressed_matmul", us,
                 f"weight_bytes {dense_bytes}->{stream_bytes} "
                 f"({dense_bytes / stream_bytes:.1f}x less HBM)"))

    s = T(rng.normal(size=(256, 512)).astype(np.float32))
    us, out = time_us(lambda: fused_softmax(s), device)
    err = (out - torch.softmax(s, -1)).abs().max().item()
    outputs["kernels/afu_softmax_lut"] = (out,
                                          fused_softmax(s, use_kernel=False))
    rows.append(("kernels/afu_softmax_lut", us, f"max_err_vs_exact={err:.1e}"))
    return Table(rows, {"max_err_vs_exact": err}, outputs)


def bench_decode_attn(device: torch.device, num_slots: int = 8,
                      cache_len: int = 128, block_k: int = 32) -> Table:
    """The int8 contiguous decode kernel on a mixed-length slot workload
    against the dense oracle, plus the blocks-visited ratio of the
    predicated walk (the work that follows occupancy, not cache_len)."""
    from repro_torch.kernels import block_stats, fused_decode_attention
    from repro_torch.models.layers import kv_quantize

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(0)
    Hq, Hkv, D = 8, 2, 32
    lengths = rng.integers(4, cache_len - 8, size=num_slots)
    q = T(rng.normal(size=(num_slots, Hq, D)).astype(np.float32))
    kf = rng.normal(size=(num_slots, cache_len, Hkv, D)).astype(np.float32)
    vf = rng.normal(size=(num_slots, cache_len, Hkv, D)).astype(np.float32)
    kq, ks = kv_quantize(T(kf))
    vq, vs = kv_quantize(T(vf))
    lens = T(lengths.astype(np.int32))
    fused_us, fused = time_us(lambda: fused_decode_attention(
        q, kq, vq, lens, k_scale=ks, v_scale=vs, block_k=block_k), device)
    dense_us, dense = time_us(lambda: fused_decode_attention(
        q, kq, vq, lens, k_scale=ks, v_scale=vs, use_kernel=False), device)
    bs = block_stats(lengths, cache_len, block_k)
    how = "cuda kernel" if device.type == "cuda" else "cpu plain version"
    metrics = {
        "fused_us_per_call": fused_us,
        "dense_us_per_call": dense_us,
        "tokens_per_s_fused": num_slots / (fused_us * 1e-6),
        "tokens_per_s_dense": num_slots / (dense_us * 1e-6),
        "kv_blocks_visited": bs["visited"],
        "kv_blocks_dense": bs["dense"],
        "kv_block_ratio": bs["ratio"],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    rows = [
        ("decode_attn/fused", fused_us,
         f"tok/s={num_slots / (fused_us * 1e-6):.0f} ({how})"),
        ("decode_attn/dense", dense_us,
         f"tok/s={num_slots / (dense_us * 1e-6):.0f} (full-cache dequant)"),
        ("decode_attn/blocks", 0.0,
         f"visited={bs['visited']}/{bs['dense']} "
         f"ratio={bs['ratio']:.2f} (target <0.7: work follows occupancy)"),
    ]
    return Table(rows, metrics, {"decode_attn/fused": (fused, dense)})


def run(tables, device: torch.device) -> Dict[str, Table]:
    """{table: Table} for each named table, in order."""
    fns = {"kernels": bench_kernels, "decode_attn": bench_decode_attn}
    return {name: fns[name](device) for name in tables}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tables", nargs="*", metavar="TABLE",
                    help=f"any of {', '.join(TABLES)} (default: all)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None,
                    help="directory for one BENCH_<table>.json per table")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.tables) - set(TABLES))
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from {list(TABLES)}")
    device = resolve_device(args.device)
    results = run(args.tables or TABLES, device)
    print("name,us_per_call,derived")
    for name, (rows, metrics, _) in results.items():
        for row, us, derived in rows:
            print(f"{row},{us:.1f},{derived}")
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"BENCH_{name}.json").write_text(json.dumps(
                {"table": name,
                 "rows": [{"name": r[0], "us_per_call": r[1],
                           "derived": r[2]} for r in rows], **metrics},
                indent=1, default=float) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

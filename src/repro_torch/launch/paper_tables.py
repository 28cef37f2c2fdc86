"""The paper's analytic tables: the reference's ``params``, ``ema``,
``macs``, ``utilization`` and ``latency_energy`` benchmark tables
(``benchmarks/tables.py``) over the port's chip model (``core/ema.py``).

  PYTHONPATH=src python -m repro_torch.launch.paper_tables \\
      [params] [ema] [macs] [utilization] [latency_energy]

Same row names and derived strings as the reference (``params/<workload>``,
``ema/<workload>``, ``macs/<workload>``, ``util/<workload>`` with the
measured packing row ``util/packing_measured``, ``lat_energy/<workload>``),
printed as the CSV ``name,us_per_call,derived``. Everything is host-side
arithmetic on the T-REX chip's constants: no row is a measurement of the
GPU. ``us_per_call`` is 0 on the analytic rows; on ``util/packing_measured``
it is the host time of ``core/packing.pack_requests`` over 64 requests of
``data.request_lengths(64, 128, "bert")``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import ema
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.core.packing import (PackingPolicy, pack_requests,
                                      packing_utilization)
from repro_torch.data import request_lengths

FCFG = FactorizationConfig(enabled=True)
Row = Tuple[str, float, str]
TABLES = ("params", "ema", "macs", "utilization", "latency_energy")


def bench_params() -> List[Row]:
    """E1: parameter size reduction 15.9-25.5x (Fig 23.1.6)."""
    rows = []
    for name, w in ema.PAPER_WORKLOADS.items():
        dense = ema.dense_weight_bits(w)
        trex = ema.trex_weight_bits(w, FCFG)["total"]
        rows.append((f"params/{name}", 0.0,
                     f"reduction={dense / trex:.1f}x (paper 15.9-25.5x)"))
    return rows


def bench_ema() -> List[Row]:
    """E2: EMA reduction 31-65.9x (Fig 23.1.1/23.1.6)."""
    rows = []
    for name, w in ema.PAPER_WORKLOADS.items():
        r = ema.ema_report(w, FCFG)
        rows.append((
            f"ema/{name}", 0.0,
            f"fact={r['reduction_factorize']:.1f}x(8.5-10.7) "
            f"comp={r['reduction_compress']:.2f}x(2.1-2.9) "
            f"batch={r['reduction_batching']:.2f}x "
            f"total={r['reduction_total']:.1f}x(31-65.9)"))
    return rows


def bench_macs() -> List[Row]:
    """E3: MAC reduction 1-2.14x against the dense X @ W."""
    rows = []
    for name, w in ema.PAPER_WORKLOADS.items():
        ratio = ema.macs_per_token(w, None) / ema.macs_per_token(w, FCFG)
        rows.append((f"macs/{name}", 0.0,
                     f"reduction={ratio:.2f}x (paper 1-2.14x)"))
    return rows


def bench_utilization() -> List[Row]:
    """E4: utilization 1.2-3.4x (Fig 23.1.4/23.1.5), plus the packing
    utilization measured on a sampled request trace."""
    rows = []
    for name, w in ema.PAPER_WORKLOADS.items():
        u = ema.utilization_report(w)
        rows.append((f"util/{name}", 0.0,
                     f"improvement={u['improvement']:.2f}x (paper 1.2-3.4x) "
                     f"fill {u['fill_baseline']:.2f}->{u['fill']:.2f} "
                     f"trf=+{(u['trf_gain'] - 1) * 100:.0f}%(12-20%)"))
    rng = np.random.default_rng(0)
    lens = request_lengths(64, 128, "bert")
    reqs = [rng.integers(0, 100, size=n).astype(np.int32) for n in lens]
    t0 = time.perf_counter()
    packed = pack_requests(reqs, PackingPolicy(128, 4))
    us = (time.perf_counter() - t0) * 1e6
    base = np.mean(lens) / 128
    fill = packing_utilization(packed)
    rows.append(("util/packing_measured", us,
                 f"fill={fill:.2f} vs unpacked {base:.2f} "
                 f"({fill / base:.2f}x)"))
    return rows


def bench_latency_energy() -> List[Row]:
    """E5: 68-567 us/token, 0.41-3.95 uJ/token (Fig 23.1.6/23.1.7), on
    the T-REX chip model."""
    rows = []
    for name in ("vit", "mt", "s2t", "bert"):
        w = ema.PAPER_WORKLOADS[name]
        s = ema.latency_energy_report(w, FCFG, corner="slow")
        f = ema.latency_energy_report(w, FCFG, corner="fast")
        rows.append((
            f"lat_energy/{name}", 0.0,
            f"slow={s['us_per_token']:.0f}us/{s['uJ_per_token']:.2f}uJ "
            f"(paper 68-567us/0.41-3.95uJ) fast={f['us_per_token']:.0f}us "
            f"ema_share={s['uJ_ema'] / s['uJ_per_token']:.0%}(<=81%)"))
    return rows


BENCHES = {"params": bench_params, "ema": bench_ema, "macs": bench_macs,
           "utilization": bench_utilization,
           "latency_energy": bench_latency_energy}


def run(tables=TABLES) -> Dict[str, List[Row]]:
    return {name: BENCHES[name]() for name in tables}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tables", nargs="*", metavar="TABLE",
                    help=f"any of {', '.join(TABLES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.tables) - set(TABLES))
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from {list(TABLES)}")
    print("name,us_per_call,derived")
    for rows in run(args.tables or TABLES).values():
        for row, us, derived in rows:
            print(f"{row},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

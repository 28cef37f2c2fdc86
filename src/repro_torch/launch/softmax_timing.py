"""Time ``softmax_lut`` on the card beside ``torch.softmax`` and its bound,
at ``chip_smoke.py``'s ``SOFTMAX_SHAPES`` (f32 input), with the smoke's own
timers (``time_ms``: CUDA events around one call, host dispatch included;
``device_ms``: the call's kernels alone; L2 flushed before each call) and
the wrapper's host time a call (``host_call_us``: ``HOST_CALLS`` calls
enqueued back to back, no sync between them).

  python src/repro_torch/launch/softmax_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (the
kernels are built under that checkout's ``build/kernels``), so that two
checkouts can be compared in one run on one card: parent, change, change,
parent. Prints one JSON line a shape, then one with the card's name and
power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
HOST_CALLS = 200  # back-to-back calls for the wrapper's host time a call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("softmax_timing: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent  # run as a file: not a package
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as smoke
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import exp_lut_table
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    table = exp_lut_table(dev)
    for R, C in smoke.SOFTMAX_SHAPES:
        x = torch.randn(R, C, generator=g, device=dev) * 4
        n0 = afu.LAUNCHES["softmax_lut"]
        afu.softmax_lut(x, table)
        launches = afu.LAUNCHES["softmax_lut"] - n0
        fn = (lambda x=x: afu.softmax_lut(x, table))
        lib = (lambda x=x: torch.softmax(x, -1))
        bms, by = smoke.bound(R * C * (4 + 4) + 256, 14 * R * C, 4)
        ms, dms = smoke.time_ms(torch, fn), smoke.device_ms(torch, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        print(json.dumps({
            "label": args.label, "shape": [R, C],
            "regime": (afu.softmax_regime(C)
                       if hasattr(afu, "softmax_regime") else None),
            "launches_per_call": launches, "ms": ms, "device_ms": dms,
            "host_ms": ms - dms, "host_call_us": host_us,
            "library_ms": smoke.time_ms(torch, lib),
            "library_device_ms": smoke.device_ms(torch, lib),
            "bound_ms": bms, "bound_by": by}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi,
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

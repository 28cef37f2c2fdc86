"""The benchmark of the PyTorch and CUDA port: one cell, one run.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``bench/configs/``: its sizes, and
the modules of its architecture and its plain reference,
``bench/lib/arch.py``) and a traffic mix (``bench/traffic/``). The run
builds the configuration on the card with weights drawn there from
``--seed``, serves the mix through
``repro_torch.serve.Engine`` (closed loop: set-up ends once every caller
has its first token; open loop: two warm-up requests), measures for
``--seconds``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced) and ``checks`` (each number compared, with its
limit; also the last lines on standard error).

``--readings 1`` adds the control's reading (the reference in float8) to
the check, for setting limits, and the open loop's backlog at the close;
``--rate R`` serves an open mix at R requests a second instead of its own
rate, for finding the knee. The benchmark's own runs use neither.

Exits non-zero with no result when there is no CUDA device or fewer than
the cell asks for, and when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from bench.lib import arch, check, drive, program, trace  # noqa: E402
from bench.lib.readers import Run, load_reader  # noqa: E402
from bench.lib.traffic import Mix, draw_items, load_mix  # noqa: E402
from bench.lib.weights import make_tree  # noqa: E402

T_HARNESS = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cell_metrics(bench: Dict, workload: str, traced: bool):
    """The names of the metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m["name"] for m in group
            if "workloads" not in m or workload in m["workloads"]]


def serve(spec, mix: Mix, seed: int, seconds: float,
          traced: bool, device, t_start: float, early=()):
    """Set-up, then the window: ``(window, trace or None, memory peak)``.
    ``early``: set-up's ``(phase, end)`` marks before this call, printed
    with its own. The engine and its weights are freed before this
    returns."""
    cuda = torch.device(device).type == "cuda"
    marks = [("start", t_start), *early]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    program.import_program()
    mark("import_program")
    program.build_kernels(device)
    mark("build")
    tree = make_tree(spec, seed, device)
    mark("weights")
    eng = program.build_engine(spec, tree, mix.engine, device)
    mark("engine")
    items = draw_items(mix, seed, spec.vocab, seconds)
    tracer = trace.Tracer(device) if traced else None
    mark("traffic")
    if mix.loop == "closed":
        w = drive.closed_loop(eng, mix, items, seconds, tracer)
    else:
        drive.warm_open(eng, spec.vocab)
        w = drive.open_loop(eng, mix, items, seconds, tracer)
    marks.append(("warm", w.setup_end))
    print("setup: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in
                                zip(marks, marks[1:])), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return w, tracer.result if tracer is not None else None, peak


def tally(w: drive.Window):
    """``(attempted, failed, done, backlog)``: the requests the window
    took on, those that ended in another status than ok, the ``(prompt,
    output)`` of those it finished, and the open loop's backlog readings
    (requests due but without a first token at the close; median TTFT of
    the window's two halves)."""
    attempted = [r for r in w.reqs.values() if r.due < w.t_close
                 and (r.finished is None or r.finished >= w.t0)]
    failed = sum(1 for r in attempted
                 if r.status is not None and r.status != "ok")
    done = [(r.item.prompt, list(r.req.output)) for r in w.reqs.values()
            if r.status == "ok" and r.finished is not None
            and w.t0 <= r.finished <= max(w.t_last, w.t0)]
    half = w.t0 + (w.t_close - w.t0) / 2
    first = [(r.due, r.times[0] - r.due) for r in w.reqs.values()
             if r.times and w.t0 <= r.due < w.t_close]
    backlog = {
        "backlog_at_close": sum(
            1 for r in w.reqs.values() if r.due < w.t_close
            and r.finished is None and not any(t <= w.t_last
                                               for t in r.times)),
        "ttft_p50_first_half": float(np.median(
            [t for d, t in first if d < half] or [np.nan])),
        "ttft_p50_second_half": float(np.median(
            [t for d, t in first if d >= half] or [np.nan]))}
    return attempted, failed, done, backlog


def run_cell(spec, mix: Mix, workload: str, seed: int,
             seconds: float, traced: bool, device, limits: Dict,
             metric_names, t_start: float, readings: bool = False,
             early=(), reference: str = arch.DENSE_REFERENCE) -> Dict:
    """One run of a cell on ``device``; returns the result line's object.
    ``reference``: the configuration's ``reference`` key."""
    cuda = torch.device(device).type == "cuda"
    w, tr, peak = serve(spec, mix, seed, seconds, traced, device, t_start,
                        early)
    run = Run(workload=workload, spec=spec, mix=mix, window=w,
              setup_s=w.setup_end - t_start, trace=tr)
    kind = "metrics" if traced else "endtoend"
    metrics = {}
    for name in metric_names:
        mod = load_reader(kind, name)
        v = mod.read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": mod.UNIT}
    attempted, failed, done, backlog = tally(w)
    checked = check.sample(done, seed)
    got = check.gaps(spec, seed, checked, device, reference,
                     control=readings) \
        if checked else {"widest_gap": None, "served_tokens_checked": 0,
                         "control_widest_gap": None}
    lim = limits["widest_gap"]["limit"]
    out = {"correct": bool(checked) and got["widest_gap"] <= lim,
           "attempted": len(attempted), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device)
                      if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        print(f"trace: busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s;"
              f" device time outside the traced steps {tr['outside_s']:.4f}"
              " s", file=sys.stderr)
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["top"]],
            "idle_gaps": sorted(([k, v] for k, v in
                                 tr["idle_by_host"].items()),
                                key=lambda kv: -kv[1])[:10]}
    if readings:
        out["readings"] = dict(got, **backlog)
    out["checks"] = {"widest_gap": {"value": got["widest_gap"],
                                    "limit": lim}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = next((c for c in bench["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    raw = json.loads((ROOT.parent / conf["file"]).read_text())
    spec = arch.spec_from_dict(raw)
    mix = load_mix(ROOT / "traffic" / f"{cell['traffic']}.json")
    if args.rate is not None:
        mix = dataclasses.replace(mix, rate_per_s=args.rate)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    early = [("import_torch", T_TORCH), ("import_harness", T_HARNESS),
             ("cuda_init", time.perf_counter())]
    out = run_cell(spec, mix, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", check.limits(ROOT, args.workload),
                   cell_metrics(bench, args.workload, bool(args.trace)),
                   T_START, readings=bool(args.readings), early=early,
                   reference=raw["reference"])
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time goes in the full-width serve: the workload of
``chip_smoke.py``'s serve phase under ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--compressed] \\
      [--serialized] [--contiguous] [--kv-quant]

Builds the serve configuration that ``chip_smoke.py``'s serve phase
shares (:func:`serve_config` and :data:`ENGINE_KW`: qwen2.5-32b at its
published widths, depth cut to 8 layers, random weights from seed 0),
serves :func:`workload` once to warm up, once plainly and once under the
profiler, and prints one JSON object: for each step kind (mixed, decode,
and the prefill sweeps of the phase-serialized engine) the step count,
the mean host wall per step with and without the profiler, the mean
device-busy time per step (union of kernel intervals), its split by kernel
category, the kernel launches per step (in all and by category; the decode
kernels merge their splits inside their one launch), and the device's idle
share against the unprofiled host step time (the profiler itself slows
the host). Kernels
are assigned to the step whose host range contains their start: every
step ends in a host sync, so its kernels finish inside its range. With
``--compressed`` it profiles :func:`compressed_config` instead, served
from the compressed streams (weights projected and compressed on the card
first). ``--serialized``, ``--contiguous`` and ``--kv-quant`` select the
phase-serialized engine, contiguous lanes and int8 K/V lanes (the last two
imply the serialized engine), as ``launch/serve.py`` does. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["ENGINE_KW", "serve_config", "compressed_config", "workload",
           "main"]

# The full-width serve's engine settings (besides ``prefix_share=False``):
# paged lanes of 128-token pages and mixed steps of chunk width 256.
ENGINE_KW = dict(max_len=256, max_new_tokens=32, num_slots=8)

_KINDS = {"mixed": "_run_mixed", "decode": "_run_decode",
          "prefill": "_prefill_admission"}
_CATEGORIES = (
    ("tda_paged_decode", ("pagedaddr",)),
    ("tda_decode", ("laneaddr",)),
    ("tda_mixed", ("mixed_kernel", "mixed_tc_kernel")),
    ("dmm", ("dmm_kernel", "dmm_tc_kernel", "dmm_small_kernel",
             "sum_splits")),
    ("smm", ("smm_kernel", "smm_small_kernel", "smm_tc_kernel")),
    ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")),
    ("gather_scatter_copy", ("index", "gather", "scatter", "copy", "memcpy",
                             "memset", "cat")),
)


def serve_config():
    """qwen2.5-32b at its published widths, depth cut from 64 to 8 layers."""
    from repro_torch.configs import get_config
    return get_config("qwen2.5-32b", "full", n_layers=8)


def compressed_config():
    """:func:`serve_config` factorized with the T-REX defaults (rank 0.625
    and nnz 0.125 of the rank, every linear at these widths), served from
    compressed streams by ``chip_smoke.py``'s compressed phase."""
    from repro_torch.configs import get_config
    return get_config("qwen2.5-32b", "full", factorized=True, n_layers=8)


def workload(vocab: int, max_new: int, seed: int = 0):
    """The full-width serve workload: a warm-up request, then 16 greedy
    requests with prompt lengths drawn in [32, 512] — 8 submitted up front,
    8 arriving at ticks 4, 7, ..., 25. Returns ``(warmup, up_front,
    arrivals, prompt_lengths)``."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    warm = Request(rid=-1, prompt=rng.integers(0, vocab, size=40)
                   .astype(np.int32), max_new_tokens=4)
    lengths = rng.integers(32, 513, size=16)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, size=int(n))
                    .astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(lengths)]
    arrivals = [(4 + 3 * i, r) for i, r in enumerate(reqs[8:])]
    return warm, reqs[:8], arrivals, lengths


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise_other"


def _union(iv: List[Tuple[float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--compressed", action="store_true")
    ap.add_argument("--serialized", action="store_true")
    ap.add_argument("--contiguous", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    args = ap.parse_args(argv)
    cfg = compressed_config() if args.compressed else serve_config()
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    kw = ENGINE_KW
    model = Model(cfg)
    params = model.init(seed=0)
    wsb = None
    if args.compressed:
        model, params, stats = model.compress_params(
            project_wd_leaves(params, cfg.factorization))
        wsb = stats["weight_stream_bits"]
    eng = Engine(model, params, config=EngineConfig(
        prefix_share=False, weight_stream_bits=wsb,
        paged=not args.contiguous,
        mixed=False if args.serialized else None, **kw))
    del params
    warm, up_front, arrivals, _ = workload(cfg.vocab_size, kw["max_new_tokens"])
    eng.submit(warm)
    eng.run()
    # One run without the profiler: its host step times are the baseline
    # (the profiler's own host overhead inflates the profiled ones).
    _, up_front, arrivals, _ = workload(cfg.vocab_size, kw["max_new_tokens"])
    for r in up_front:
        eng.submit(r)
    eng.run(arrivals=arrivals)
    plain_ms = {k: float(np.mean(v)) if v else 0.0
                for k, v in eng.decode_stats["step_ms"].items()}
    _, up_front, arrivals, _ = workload(cfg.vocab_size, kw["max_new_tokens"])

    for kind, attr in _KINDS.items():
        fn = getattr(eng, attr)

        def wrapped(*a, _fn=fn, _name=f"serve.{kind}_step"):
            with record_function(_name):
                return _fn(*a)
        setattr(eng, attr, wrapped)
    for r in up_front:
        eng.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = eng.run(arrivals=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # Host ranges of the steps; device kernels (the profiler also mirrors
    # each record_function range onto the device timeline: skip those).
    steps = [(e.name.split(".")[1].split("_")[0], e.time_range.start,
              e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU
             and e.name in {f"serve.{k}_step" for k in _KINDS}]
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("serve.")]
    steps.sort(key=lambda s: s[1])
    starts = np.array([s[1] for s in steps])
    per: Dict[str, dict] = {}
    for kind in _KINDS:
        per[kind] = {"steps": 0, "host_ms": 0.0, "by_category_ms": {},
                     "launches": {}, "intervals": []}
    for kind, a, b in steps:
        per[kind]["steps"] += 1
        per[kind]["host_ms"] += (b - a) / 1e3
    for name, a, b in kernels:
        i = int(np.searchsorted(starts, a, side="right")) - 1
        if i < 0 or a > steps[i][2]:
            continue  # outside any step (e.g. admission-time table copies)
        p = per[steps[i][0]]
        cat = _category(name)
        p["by_category_ms"][cat] = p["by_category_ms"].get(cat, 0.0) \
            + (b - a) / 1e3
        p["launches"][cat] = p["launches"].get(cat, 0) + 1
        p["intervals"].append((a, b))
    out = {"model": cfg.name, "n_layers": cfg.n_layers,
           "weight_format": model.cfg.weight_format,
           "engine": "mixed" if eng.mixed else "serialized",
           "lanes": "paged" if eng.paged else "contiguous",
           "kv_quant": cfg.kv_quant,
           "device": torch.cuda.get_device_name(0),
           "requests": len(done), "wall_s": wall,
           "kernel_events": len(kernels)}
    busy_all = _union([(a, b) for _, a, b in kernels]) / 1e3
    out["device_busy_s"] = busy_all / 1e3
    out["idle_share"] = 1.0 - busy_all / 1e3 / wall
    for kind, p in per.items():
        n = max(p["steps"], 1)
        busy = _union(p.pop("intervals")) / 1e3
        out[kind] = {"steps": p["steps"],
                     "host_ms_per_step_profiled": p["host_ms"] / n,
                     "host_ms_per_step_unprofiled": plain_ms[kind],
                     "device_busy_ms_per_step": busy / n,
                     "idle_share_vs_unprofiled": 1.0 - busy / n
                     / max(plain_ms[kind], 1e-9),
                     "by_category_ms_per_step": {
                         k: v / n for k, v in sorted(
                             p["by_category_ms"].items())},
                     "launches_per_step": sum(p["launches"].values()) / n,
                     "launches_by_category_per_step": {
                         k: v / n for k, v in sorted(
                             p["launches"].items())}}
    top = {}
    for name, a, b in kernels:
        top[name[:96]] = top.get(name[:96], 0.0) + (b - a) / 1e3
    out["top_kernels_ms"] = dict(sorted(top.items(), key=lambda kv: -kv[1])
                                 [:12])
    print(json.dumps(out))


if __name__ == "__main__":
    main()

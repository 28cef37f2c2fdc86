"""Where the time goes in the full-width serve: the workload of
``chip_smoke.py``'s serve phase under ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--compressed] \\
      [--serialized] [--contiguous] [--kv-quant] [--shared [--pool-frac F]] \\
      [--sampled] [--arch starcoder2-15b|dbrx-132b|mamba2-370m|\
      recurrentgemma-2b [--n-layers N]]

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
imply the serialized engine), as ``launch/serve.py`` does. ``--shared``
profiles :func:`shared_workload` (system-prompt traffic) through the
default ``EngineConfig`` (prefix sharing on), ``--pool-frac`` cutting the
page pool as ``chip_smoke.py``'s shared phase does. ``--sampled`` serves
with seeded sampling (:data:`SAMPLED`: temperature 0.8, top-k 50) instead
of greedy decoding. ``--arch starcoder2-15b`` profiles the ring serve
instead (:func:`ring_config`, :data:`RING_ENGINE_KW`,
:func:`ring_workload`: starcoder2-15b at its published widths with bf16
weights, sliding-window ring lanes of 4096 tokens, the default
``EngineConfig`` with prefix sharing, long-context traffic that wraps the
rings), as ``chip_smoke.py``'s ring_serve phase serves it; ``--arch
dbrx-132b`` profiles the MoE serve (:func:`moe_config` with
:data:`ENGINE_KW` and :func:`workload`, as ``chip_smoke.py``'s moe_serve
phase serves it: routed experts, every mixed-step column computed);
``--arch mamba2-370m`` and ``--arch recurrentgemma-2b`` profile the
recurrent serves (:func:`recurrent_config`: published widths, full depth,
bf16 weights; :data:`ENGINE_KW` and :func:`workload` through the default
``EngineConfig``, which resolves to the phase-serialized engine, paged
for recurrentgemma's local layers and unpaged for mamba2), as
``chip_smoke.py``'s recurrent_serve phase serves them; ``--n-layers``
cuts any of these archs' depth. Every step also reports its token
choice alone (``choose_*``: the kernels launched inside ``Engine._choose``,
the argmax of a greedy step or the sampler of a sampled one), found
through the profiler's op tree. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["ENGINE_KW", "SAMPLED", "SYSTEM_PROMPT", "RING_ENGINE_KW",
           "RING_PREFIX", "MOE_LAYERS", "serve_config", "compressed_config",
           "ring_config", "moe_config", "recurrent_config",
           "RECURRENT_ARCHS", "workload", "shared_workload",
           "ring_workload", "profile_run", "range_kernels", "main"]

# The full-width serve's engine settings: paged lanes of 128-token pages
# and mixed steps of chunk width 256 (``workload`` serves them with
# ``prefix_share=False``, ``shared_workload`` with the default sharing).
ENGINE_KW = dict(max_len=256, max_new_tokens=32, num_slots=8)
SYSTEM_PROMPT = 256  # tokens: two full 128-token pages
# The sampled serve's engine-wide sampling (``--sampled``, chip_smoke.py's
# sampled_serve phase).
SAMPLED = dict(temperature=0.8, top_k=50)

# The ring serve (``--arch starcoder2-15b``, chip_smoke.py's ring_serve
# phase): 8 slots whose lanes clamp to starcoder2's window of 4096 tokens
# (32 pages of 128), chunks of at most 2048 prompt tokens a step, 32 new
# tokens; max_len 5120 admits prompts of up to 10240 tokens (cache_len
# 10272), so the window, not the cache, sizes the lanes.
RING_ENGINE_KW = dict(max_len=5120, max_new_tokens=32, num_slots=8,
                      page_size=128, prefill_budget=2048)
RING_PREFIX = 2048  # tokens two of the window-crossing prompts share

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
    ("sort_scan", ("sort", "scan")),  # the MoE router's top-k and ranks
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


def ring_config(n_layers=None):
    """starcoder2-15b at its published widths (d_model 6144, 48 q / 4 kv
    heads of 128, d_ff 24576, vocab 49152, window 4096, rope_theta 1e5)
    with bf16 weights (``param_dtype``: the 40 layers' ~16 B parameters
    take ~32 GB); ``n_layers`` cuts the depth."""
    from repro_torch.configs import get_config
    over = {} if n_layers is None else {"n_layers": n_layers}
    return get_config("starcoder2-15b", "full", param_dtype="bfloat16",
                      **over)


# The MoE serve's depth: dbrx-132b's 40 layers cut to 8 (each layer's 16
# experts of 3 x 6144 x 10752 take 6.3 GB in bf16: 8 layers, the embedding
# and the head come to about 53 GB of the card's 80).
MOE_LAYERS = 8


def moe_config(n_layers=MOE_LAYERS):
    """dbrx-132b at its published widths (d_model 6144, 48 q / 8 kv heads
    of 128, 16 experts of d_ff 10752, top-4, capacity factor 1.25, vocab
    100352, rope_theta 5e5) with bf16 weights (``param_dtype``), depth cut
    from 40 to ``n_layers``."""
    from repro_torch.configs import get_config
    return get_config("dbrx-132b", "full", param_dtype="bfloat16",
                      n_layers=n_layers)


RECURRENT_ARCHS = ("mamba2-370m", "recurrentgemma-2b")


def recurrent_config(arch: str, n_layers=None):
    """A recurrent stack at its published widths and full depth with bf16
    weights (``param_dtype``): mamba2-370m (48 SSD layers, d_model 1024,
    state 128, 32 heads of 64, vocab 50280, tied; ~0.74 GB) or
    recurrentgemma-2b (26 layers of rglru, rglru, local attention: d_model
    2560, RG-LRU width 2560, 10 q heads / 1 kv head of 256, window 2048,
    d_ff 7680, vocab 256000, tied; ~5.8 GB); ``n_layers`` cuts the
    depth."""
    from repro_torch.configs import get_config
    if arch not in RECURRENT_ARCHS:
        raise ValueError(f"not a recurrent arch: {arch}")
    over = {} if n_layers is None else {"n_layers": n_layers}
    return get_config(arch, "full", param_dtype="bfloat16", **over)


def ring_workload(vocab: int, max_new: int, seed: int = 0):
    """Long-context code completion over ring lanes of 4096 tokens: a
    300-token warm-up request, then 12 greedy requests. Four short
    prompts in [256, 1024] never wrap; four in [4066, 4090] cross the
    window while decoding ``max_new`` = 32 tokens, and two of these share a
    :data:`RING_PREFIX`-token prefix: the first is submitted up front, the
    second arrives at tick 3, after the first has published its prompt's
    pages, so it maps the shared pages and a ring that wraps into them
    copies one; four in [4200, 5000] wrap inside their prompt chunks. Seven
    requests up front, the other five at ticks 3, 4, 6, 8, 10. Token ids
    below ``vocab`` (pass 256 to serve the same prompts on the CPU smoke
    config). Returns ``(warmup, up_front, arrivals, prompt_lengths)``."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(0, vocab, size=int(n)).astype(np.int32)

    warm = Request(rid=-1, prompt=toks(300), max_new_tokens=4)
    short = rng.integers(256, 1025, size=4)
    cross = rng.integers(4066, 4091, size=4)
    wrap = rng.integers(4200, 5001, size=4)
    prefix = toks(RING_PREFIX)
    prompts = {
        "cross0": np.concatenate([prefix, toks(cross[0] - RING_PREFIX)]),
        "cross1": np.concatenate([prefix, toks(cross[1] - RING_PREFIX)]),
        "cross2": toks(cross[2]), "cross3": toks(cross[3]),
        **{f"short{i}": toks(n) for i, n in enumerate(short)},
        **{f"wrap{i}": toks(n) for i, n in enumerate(wrap)}}
    order = ["cross0", "wrap0", "short0", "short1", "wrap1", "cross2",
             "short2", "cross1", "short3", "wrap2", "wrap3", "cross3"]
    reqs = [Request(rid=i, prompt=prompts[k], max_new_tokens=max_new)
            for i, k in enumerate(order)]
    arrivals = [(t, r) for t, r in zip((3, 4, 6, 8, 10), reqs[7:])]
    lengths = np.array([len(r.prompt) for r in reqs])
    return warm, reqs[:7], arrivals, lengths


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


def shared_workload(vocab: int, max_new: int, seed: int = 0):
    """System-prompt traffic: a warm-up request, then 16 greedy requests,
    each one :data:`SYSTEM_PROMPT`-token system prompt (the same for all)
    followed by its own suffix of a length uniform in [16, 240] — 8
    submitted up front, 8 arriving at ticks 4, 7, ..., 25, as in
    :func:`workload`. Token ids are drawn below ``vocab`` (pass the smoke
    vocabulary, 256, to serve the same prompts on the CPU smoke config).
    Returns ``(warmup, up_front, arrivals, prompt_lengths)``."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    warm = Request(rid=-1, prompt=rng.integers(0, vocab, size=40)
                   .astype(np.int32), max_new_tokens=4)
    system = rng.integers(0, vocab, size=SYSTEM_PROMPT).astype(np.int32)
    suffixes = rng.integers(16, 241, size=16)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [system, rng.integers(0, vocab, size=int(n)).astype(np.int32)]),
        max_new_tokens=max_new) for i, n in enumerate(suffixes)]
    arrivals = [(4 + 3 * i, r) for i, r in enumerate(reqs[8:])]
    return warm, reqs[:8], arrivals, suffixes + SYSTEM_PROMPT


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


def range_kernels(event) -> Tuple[int, float]:
    """(launches, device ms) of the kernels launched inside one host range
    of the profiler's op tree (the range's own device mirror left out)."""
    n, us, stack = 0, 0.0, [event]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            if k.name != event.name:
                n += 1
                us += k.duration
        stack.extend(e.cpu_children)
    return n, us / 1e3


def profile_run(eng, up_front, arrivals, plain_ms: Dict[str, float]):
    """Serve ``up_front`` (submitted first) and ``arrivals`` through
    ``eng.run`` under ``torch.profiler`` and return the per-step breakdown
    by step kind (see the module docstring) against ``plain_ms``, the same
    run's host ms per step without the profiler. Wraps the engine's step
    and token-choice methods in named ranges for the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    wrapped_attrs = dict(_KINDS, choose="_choose")
    for kind, attr in wrapped_attrs.items():
        fn = getattr(eng, attr)
        name = "serve.choose" if kind == "choose" else f"serve.{kind}_step"

        def wrapped(*a, _fn=fn, _name=name):
            with record_function(_name):
                return _fn(*a)
        setattr(eng, attr, wrapped)
    try:
        for r in up_front:
            eng.submit(r)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done = eng.run(arrivals=arrivals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for attr in wrapped_attrs.values():
            delattr(eng, attr)
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
                     "launches": {}, "intervals": [], "choose": [0, 0.0]}
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
    for e in events:
        if e.device_type == DeviceType.CPU and e.name == "serve.choose":
            i = int(np.searchsorted(starts, e.time_range.start,
                                    side="right")) - 1
            if i >= 0:
                n, ms = range_kernels(e)
                per[steps[i][0]]["choose"][0] += n
                per[steps[i][0]]["choose"][1] += ms
    out = {"requests": len(done), "wall_s": wall,
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
                             p["launches"].items())},
                     "choose_launches_per_step": p["choose"][0] / n,
                     "choose_device_ms_per_step": p["choose"][1] / n}
    top = {}
    for name, a, b in kernels:
        top[name[:96]] = top.get(name[:96], 0.0) + (b - a) / 1e3
    out["top_kernels_ms"] = dict(sorted(top.items(), key=lambda kv: -kv[1])
                                 [:12])
    return out


def main(argv=None):
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--compressed", action="store_true")
    ap.add_argument("--serialized", action="store_true")
    ap.add_argument("--contiguous", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--shared", action="store_true")
    ap.add_argument("--pool-frac", type=float, default=1.0)
    ap.add_argument("--sampled", action="store_true")
    ap.add_argument("--arch", default="qwen2.5-32b",
                    choices=("qwen2.5-32b", "starcoder2-15b", "dbrx-132b")
                    + RECURRENT_ARCHS)
    ap.add_argument("--n-layers", type=int, default=None)
    args = ap.parse_args(argv)
    ring = args.arch == "starcoder2-15b"
    if args.arch != "qwen2.5-32b" and (args.compressed or args.shared):
        ap.error(f"--arch {args.arch} profiles its own serve: it takes "
                 "neither --compressed nor --shared")
    if ring:
        cfg = ring_config(args.n_layers)
    elif args.arch == "dbrx-132b":
        cfg = moe_config(args.n_layers or MOE_LAYERS)
    elif args.arch in RECURRENT_ARCHS:
        cfg = recurrent_config(args.arch, args.n_layers)
    else:
        cfg = compressed_config() if args.compressed else serve_config()
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    kw = RING_ENGINE_KW if ring else ENGINE_KW
    model = Model(cfg)
    params = model.init(seed=0)
    wsb = None
    if args.compressed:
        model, params, stats = model.compress_params(
            project_wd_leaves(params, cfg.factorization))
        wsb = stats["weight_stream_bits"]
    eng = Engine(model, params, config=EngineConfig(
        prefix_share=args.shared or ring, pool_frac=args.pool_frac,
        weight_stream_bits=wsb, paged=not args.contiguous,
        mixed=False if args.serialized else None,
        **(SAMPLED if args.sampled else {}), **kw))
    del params

    def traffic():
        if ring:  # token ids of the smoke vocabulary, as chip_smoke
            return ring_workload(256, kw["max_new_tokens"])
        if args.shared:
            return shared_workload(256, kw["max_new_tokens"])
        return workload(cfg.vocab_size, kw["max_new_tokens"])

    warm, up_front, arrivals, _ = traffic()
    eng.submit(warm)
    eng.run()
    # One run without the profiler: its host step times are the baseline
    # (the profiler's own host overhead inflates the profiled ones). With
    # sharing, each run starts from a cold prefix cache.
    _, up_front, arrivals, _ = traffic()
    for r in up_front:
        eng.submit(r)
    eng.run(arrivals=arrivals)
    plain_ms = {k: float(np.mean(v)) if v else 0.0
                for k, v in eng.decode_stats["step_ms"].items()}
    if args.shared or ring:
        eng.slots.pool.drop_prefix_cache()
    _, up_front, arrivals, _ = traffic()
    prof = profile_run(eng, up_front, arrivals, plain_ms)
    out = {"model": cfg.name, "n_layers": cfg.n_layers,
           "weight_format": model.cfg.weight_format,
           "engine": "mixed" if eng.mixed else "serialized",
           "lanes": "paged" if eng.paged else "contiguous",
           "kv_quant": cfg.kv_quant,
           "shared": args.shared, "pool_frac": args.pool_frac,
           "sampled": SAMPLED if args.sampled else None,
           "prefix_hit_ratio": eng.decode_stats["prefix_hit_ratio"],
           "pages_shared": eng.decode_stats["pages_shared"],
           "preemptions": eng.decode_stats["preemptions"],
           "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(), **prof}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

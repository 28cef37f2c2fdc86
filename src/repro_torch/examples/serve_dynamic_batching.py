"""Continuous-batching serving (``examples/serve_dynamic_batching.py``):
short prompts share prefill weight sweeps (dynamic batching), a long
prompt is chunked instead of rejected, and decode runs one step over a
slot table of per-request lanes with admissions mid-decode. Then prefix
sharing behind a 48-token system prompt, a recurrentgemma hybrid
(RG-LRU state lanes, ring lanes of a local window) through the same
engine, a misbehaving burst through the failure-hardened path (a bounded
queue, deadlines, an injected NaN quarantined to its slot, audits on),
and bursty arrivals of long prompts through the mixed step against the
phase-serialized engine.

  PYTHONPATH=src python -m repro_torch.examples.serve_dynamic_batching \\
      [--device cpu] [--dtype float32]

Each section is a function of ``(model, params, rng)`` that returns its
requests' outputs and the engine's counters; ``rng`` is one
``np.random.default_rng(0)`` drawn through the sections in order, as the
reference's example draws it. ``serve`` is the serving package whose
``Engine`` runs them (this port's; a test passes the reference's).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch import serve as port_serve
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.data import request_lengths
from repro_torch.models.transformer import Model

COUNTERS = ("decoded_tokens", "steps", "slot_utilization",
            "kv_memory_ratio", "kv_pages_total", "preemptions",
            "prefix_hit_ratio", "pages_shared", "kv_block_ratio",
            "faults_injected", "audit_violations", "mixed_steps")


def _outputs(done) -> Dict[int, list]:
    return {r.rid: [int(t) for t in r.output] for r in done}


def _counters(eng) -> Dict:
    ds = eng.decode_stats
    return {k: ds[k] for k in COUNTERS if k in ds}


def dense_section(model, params, rng, serve=port_serve) -> Dict:
    """24 requests of the bert length profile (one of 90 tokens, chunked)
    through the phase-serialized engine (packed prefill sweeps)."""
    cfg = model.cfg
    Request = serve.Request
    eng = serve.Engine(model, params, config=serve.EngineConfig(
        max_len=64, max_new_tokens=8, num_slots=8, page_size=16,
        mixed=False))
    lens = list(request_lengths(24, max_len=64, dist="bert"))
    lens[3] = 90  # one over-long prompt: chunked solo prefill, not rejected
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 9))))
    done = eng.run()
    fills = [s["utilization"] for s in eng.stats]
    return {"engine": eng, "outputs": _outputs(done),
            "counters": _counters(eng), "lens": lens, "fills": fills,
            "requests": sum(s["n_requests"] for s in eng.stats),
            "rows": sum(s["rows"] for s in eng.stats)}


def prefix_section(eng, rng, serve=port_serve) -> Dict:
    """A system prompt seeds the cache, then six requests map its pages."""
    V = eng.model.cfg.vocab_size
    Request = serve.Request
    pre = rng.integers(0, V, size=48).astype(np.int32)
    eng.submit(Request(rid=99, prompt=np.concatenate(
        [pre, pre[:5]]).astype(np.int32), max_new_tokens=2))
    first = eng.run()  # publishes the prefix pages (retained after release)
    for rid in range(6):
        eng.submit(Request(rid=100 + rid, prompt=np.concatenate(
            [pre, rng.integers(0, V, size=int(rng.integers(4, 12)))]
        ).astype(np.int32), max_new_tokens=4))
    done = eng.run()
    return {"outputs": _outputs(list(first) + list(done)),
            "counters": _counters(eng)}


def recurrent_section(rmodel, rparams, rng, serve=port_serve) -> Dict:
    """recurrentgemma through the slot engine: state and ring lanes."""
    V = rmodel.cfg.vocab_size
    Request = serve.Request
    reng = serve.Engine(rmodel, rparams, config=serve.EngineConfig(
        max_len=16, max_new_tokens=6, num_slots=4))
    for rid, n in enumerate(rng.integers(3, 14, size=12)):
        reng.submit(Request(rid=rid, prompt=rng.integers(
            0, V, size=int(n)).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 7))))
    done = reng.run()
    return {"outputs": _outputs(done), "counters": _counters(reng)}


def degraded_section(model, params, rng, serve=port_serve) -> Dict:
    """16 requests through 2 slots, ``max_pending`` 8, deadlines of 40
    ticks, one injected NaN, audits on: every request ends in a counted
    terminal status."""
    V = model.cfg.vocab_size
    Request = serve.Request
    deng = serve.Engine(model, params, config=serve.EngineConfig(
        max_len=64, max_new_tokens=8, num_slots=2, page_size=16,
        max_pending=8, audit=True),
        faults=serve.FaultPlan(seed=3, nan_at=((2, 0),)))
    for rid, n in enumerate(request_lengths(16, max_len=64, dist="bert")):
        deng.submit(Request(rid=200 + rid, prompt=rng.integers(
            0, V, size=int(n)).astype(np.int32),
            max_new_tokens=6, ttl_steps=40))
    done = deng.run()
    dds = deng.decode_stats
    if sum(dds["status_counts"].values()) != len(done) or not all(
            r.status in serve.TERMINAL_STATUSES for r in done):
        raise RuntimeError("a request of the degraded burst has no "
                           "counted terminal status")
    return {"outputs": _outputs(done), "counters": _counters(deng),
            "statuses": {r.rid: r.status for r in done},
            "status_counts": {s: n for s, n in dds["status_counts"].items()
                              if n},
            "failed": [(r.rid, r.status_reason) for r in done
                       if r.status == "failed"]}


def bursty_section(model, params, rng, serve=port_serve) -> Dict:
    """16 prompts of 280-500 tokens in three waves, the same schedule
    through the mixed step and through the phase-serialized engine; TTFT
    in modeled device tokens."""
    V = model.cfg.vocab_size
    Request = serve.Request
    burst = [(t, int(n)) for t, n in
             zip([1] * 6 + [4] * 5 + [8] * 5, rng.integers(280, 500, size=16))]

    def arrivals():
        r = np.random.default_rng(5)
        return [(t, Request(rid=400 + i, prompt=r.integers(
                     0, V, size=n).astype(np.int32),
                     max_new_tokens=int(r.integers(2, 6))))
                for i, (t, n) in enumerate(burst)]

    out = {}
    for mixed in (True, False):
        beng = serve.Engine(model, params, config=serve.EngineConfig(
            max_len=64, max_new_tokens=8, num_slots=8, page_size=8,
            max_prompt_len=512, prefix_share=False, mixed=mixed))
        done = beng.run(arrivals=arrivals())
        bds = beng.decode_stats
        dev = sorted(v["device_tokens"] for v in bds["ttft"].values())
        out["mixed" if mixed else "serialized"] = {
            "outputs": _outputs(done), "counters": _counters(beng),
            "ttft_p50": float(np.percentile(dev, 50)),
            "ttft_p99": float(np.percentile(dev, 99)),
            "ok": len(done)}
    return out


def main(argv=None, params=None, rparams=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    over = {} if args.dtype is None else {"dtype": args.dtype}
    cfg = get_config("qwen2.5-32b", "smoke", **over)
    model = Model(cfg, device=args.device)
    params = model.init(0) if params is None else tree_map(
        lambda t: t.to(model.device), params)
    rng = np.random.default_rng(0)
    seconds = {}

    t0 = time.perf_counter()
    dense = dense_section(model, params, rng)
    seconds["dense"] = time.perf_counter() - t0
    eng, lens, fills = dense["engine"], dense["lens"], dense["fills"]
    print(f"served {len(dense['outputs'])} requests, e.g. request 0 -> "
          f"{dense['outputs'][0]}")
    print(f"packed {dense['requests']} requests into {dense['rows']} "
          f"prefill rows ({dense['requests'] / dense['rows']:.2f} "
          "req/weight-sweep, paper: up to 4)")
    print(f"mean prefill fill {np.mean(fills):.2f} vs "
          f"unpacked {np.mean(lens) / 64:.2f} "
          f"-> {np.mean(fills) / (np.mean(lens) / 64):.2f}x "
          f"(paper: up to 3.31x)")
    ds = dense["counters"]
    print(f"decode: {ds['decoded_tokens']} tokens in {ds['steps']} steps, "
          f"per-step slot utilization {ds['slot_utilization']:.2f} "
          f"(the serving-side PE-utilization analogue)")
    print(f"paged lane pool: {ds['kv_pages_total']} pages x "
          f"{eng.config.page_size} tokens, mean occupancy "
          f"{ds['kv_memory_ratio']:.2f} of capacity "
          f"(contiguous lanes would pin 1.00), "
          f"{ds['preemptions']} preemptions")

    t0 = time.perf_counter()
    prefix = prefix_section(eng, rng)
    seconds["prefix"] = time.perf_counter() - t0
    ps = prefix["counters"]
    print(f"prefix sharing: 6 requests behind one 48-token system prefix "
          f"-> hit ratio {ps['prefix_hit_ratio']:.2f}, "
          f"{ps['pages_shared']} page mappings served from shared pages "
          f"(copy-on-write keeps them output-invisible)")

    rcfg = get_config("recurrentgemma-2b", "smoke", **over)
    rmodel = Model(rcfg, device=args.device)
    rparams = rmodel.init(1) if rparams is None else tree_map(
        lambda t: t.to(rmodel.device), rparams)
    t0 = time.perf_counter()
    rec = recurrent_section(rmodel, rparams, rng)
    seconds["recurrent"] = time.perf_counter() - t0
    rds = rec["counters"]
    print(f"\nrecurrent hybrid ({rcfg.name}): served {len(rec['outputs'])} "
          f"requests through RG-LRU state lanes + local-window ring lanes")
    print(f"decode: {rds['decoded_tokens']} tokens in {rds['steps']} steps, "
          f"slot utilization {rds['slot_utilization']:.2f}, "
          f"kv-block ratio {rds['kv_block_ratio']:.2f}")

    t0 = time.perf_counter()
    deg = degraded_section(model, params, rng)
    seconds["degraded"] = time.perf_counter() - t0
    print(f"\ndegraded burst (2 slots, max_pending=8, ttl=40 ticks, one "
          f"injected NaN, audits on): {len(deg['outputs'])} requests back, "
          f"per-status counts {deg['status_counts']}")
    if deg["failed"]:
        print(f"  e.g. request {deg['failed'][0][0]} failed: "
              f"{deg['failed'][0][1]}")
    dc = deg["counters"]
    print(f"  faults injected {dc['faults_injected']}, "
          f"{dc['audit_violations']} audit violations")

    t0 = time.perf_counter()
    bursty = bursty_section(model, params, rng)
    seconds["bursty"] = time.perf_counter() - t0
    print("\nbursty mid-decode arrivals (16 long prompts in 3 waves):")
    for tag, b in bursty.items():
        print(f"  {tag:12s} ttft p50/p99 = {b['ttft_p50']:.0f}/"
              f"{b['ttft_p99']:.0f} device-tokens, slot utilization "
              f"{b['counters']['slot_utilization']:.2f}, "
              f"{b['counters']['mixed_steps']} mixed steps "
              f"({b['ok']} requests ok)")
    dense.pop("engine")
    return {"dense": dense, "prefix": prefix, "recurrent": rec,
            "degraded": deg, "bursty": bursty, "seconds": seconds}


if __name__ == "__main__":
    main()

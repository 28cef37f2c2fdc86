"""Async serving over the steppable slot engine
(``examples/serve_async_frontend.py``): submit requests from asyncio
coroutines, stream tokens as they decode, cancel mid-stream, and fan a
trace out over two engine replicas that share prompt prefixes through a
fleet index.

1. **Streaming**: ``Frontend.submit`` returns a handle at once; ``async
   for tok in handle`` yields each token the step it retires. Greedy and
   ``SamplingParams`` requests share one decode step.
2. **Token identity**: the same arrival trace through the front end and
   through ``Engine.run`` gives identical outputs.
3. **Cancellation**: cancelling a handle mid-decode frees its slot and
   pages at once.
4. **Replicas and the fleet prefix**: a ``Dispatcher`` over two replicas;
   a prefix prefilled on replica A is restored on replica B from the
   fleet's host tier.

  PYTHONPATH=src python -m repro_torch.examples.serve_async_frontend \\
      [--device cpu]

``serve`` is the serving package whose classes run the sections (this
port's; a test passes the reference's).
"""
from __future__ import annotations

import argparse
import asyncio
import time
from typing import Dict

import numpy as np

from repro_torch import serve as port_serve
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.models.transformer import Model

ECFG = dict(max_len=64, max_new_tokens=8, num_slots=4, page_size=8,
            mixed=True, prefill_budget=16)


def make_requests(cfg, n: int = 8, serve=port_serve):
    """``n`` prompts of 4-15 tokens; odd rids sample (T 0.8, top-k 5,
    their own seeds), even rids are greedy."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(4, 16))).astype(np.int32)
        sp = (serve.SamplingParams(temperature=0.8, top_k=5, seed=100 + i)
              if i % 2 else None)
        reqs.append(serve.Request(rid=i, prompt=prompt, max_new_tokens=6,
                                  sampling=sp))
    return reqs


def _trace(cfg, serve=port_serve):
    return [(1 + 2 * i, r) for i, r in enumerate(make_requests(cfg,
                                                                 serve=serve))]


def reference_run(model, params, serve=port_serve) -> Dict:
    """The trace of section 1 through synchronous ``Engine.run``."""
    eng = serve.Engine(model, params, config=serve.EngineConfig(**ECFG))
    return {r.rid: [int(t) for t in r.output]
            for r in eng.run(arrivals=_trace(model.cfg, serve))}


async def serve_streaming(model, params, serve=port_serve):
    eng = serve.Engine(model, params, config=serve.EngineConfig(**ECFG))
    streamed = {}
    async with serve.Frontend(eng) as fe:
        handles = [fe.submit(r, tick=1 + 2 * i) for i, r in
                   enumerate(make_requests(model.cfg, serve=serve))]

        async def consume(h):
            streamed[h.request.rid] = [int(t) async for t in h]

        await asyncio.gather(*(consume(h) for h in handles))
    return streamed, fe.stats


async def serve_cancel(model, params, serve=port_serve):
    eng = serve.Engine(model, params, config=serve.EngineConfig(
        max_len=64, max_new_tokens=64, num_slots=4, page_size=8,
        prefix_share=False))
    async with serve.Frontend(eng) as fe:
        h = fe.submit(serve.Request(rid=0, prompt=list(range(2, 12)),
                                    max_new_tokens=64))
        got = 0
        async for _ in h:
            got += 1
            if got == 3:
                await h.cancel()
                break
        req = await h.result()
    return req, got, eng.slots.pool.memory_ratio()


def fleet_section(model, params, serve=port_serve) -> Dict:
    """A prefix prefilled on replica A, restored on replica B."""
    Request = serve.Request
    prefix = list(range(2, 2 + 24))  # 3 full pages of shared system prompt
    replicas = [serve.Engine(model, params, config=serve.EngineConfig(
        max_len=64, max_new_tokens=4, num_slots=4, page_size=8))
        for _ in range(2)]
    disp = serve.Dispatcher(replicas)
    a, b = replicas
    out_a = a.run(arrivals=[(1, Request(rid=0, prompt=prefix + [7, 8],
                                        max_new_tokens=4))])
    out_b = b.run(arrivals=[(1, Request(rid=1, prompt=prefix + [9, 10],
                                        max_new_tokens=4))])
    return {"published": disp.fleet.published,
            "restored": b.decode_stats["fleet_restored_pages"],
            "hit_ratio": b.decode_stats["prefix_hit_ratio"],
            "outputs": {r.rid: [int(t) for t in r.output]
                        for r in list(out_a) + list(out_b)}}


def dispatcher_section(model, params, serve=port_serve) -> Dict:
    """The trace of section 1 over a two-replica ``Dispatcher``."""
    disp = serve.Dispatcher([serve.Engine(
        model, params, config=serve.EngineConfig(**ECFG)) for _ in range(2)])
    done = disp.run(arrivals=_trace(model.cfg, serve))
    ds = disp.decode_stats
    return {"outputs": {r.rid: [int(t) for t in r.output] for r in done},
            "routed": ds["routed_counts"], "decoded": ds["decoded_tokens"],
            "steps": ds["steps"]}


def main(argv=None, params=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    cfg = get_config("qwen2.5-32b", "smoke", dtype=args.dtype)
    model = Model(cfg, device=args.device)
    params = model.init(0) if params is None else tree_map(
        lambda t: t.to(model.device), params)
    seconds = {}

    t0 = time.perf_counter()
    streamed, stats = asyncio.run(serve_streaming(model, params))
    ref_out = reference_run(model, params)
    seconds["streaming"] = time.perf_counter() - t0
    if streamed != ref_out:
        raise RuntimeError("async streaming diverged from Engine.run")
    print(f"streamed {len(streamed)} requests "
          f"(every other one sampled at T=0.8/top-k 5), e.g. rid 1 -> "
          f"{streamed[1]}")
    print(f"token-identical to synchronous Engine.run on the same trace; "
          f"itl p50/p99 = {stats['itl_p50']:.0f}/{stats['itl_p99']:.0f} "
          f"device-tokens")

    t0 = time.perf_counter()
    req, got, ratio = asyncio.run(serve_cancel(model, params))
    seconds["cancel"] = time.perf_counter() - t0
    if ratio != 0.0:
        raise RuntimeError(f"cancellation left pool occupancy {ratio}")
    print(f"cancelled rid {req.rid} after {got} streamed tokens: "
          f"status={req.status}, pool occupancy back to {ratio:.2f}")

    t0 = time.perf_counter()
    fleet = fleet_section(model, params)
    print(f"fleet prefix: replica A published {fleet['published']} "
          f"pages; replica B restored {fleet['restored']} from the host "
          f"tier (prefix hit ratio {fleet['hit_ratio']:.2f}) — one "
          f"prefill per fleet, not per replica")
    disp = dispatcher_section(model, params)
    seconds["fleet"] = time.perf_counter() - t0
    if disp["outputs"] != ref_out:
        raise RuntimeError("replicated fleet diverged from single engine")
    print(f"dispatcher over 2 replicas: routed {disp['routed']}, "
          f"token-identical to the single engine "
          f"({disp['decoded']} tokens, {disp['steps']} replica-steps)")
    return {"streamed": streamed, "reference": ref_out,
            "itl_p50": stats["itl_p50"], "itl_p99": stats["itl_p99"],
            "cancel": {"rid": req.rid, "got": got, "status": req.status,
                       "pool_ratio": ratio},
            "fleet": fleet, "dispatcher": disp, "seconds": seconds}


if __name__ == "__main__":
    main()

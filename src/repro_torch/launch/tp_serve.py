"""Serving on a ``(1, N)`` mesh: the function each rank runs.

:func:`serve_rank` is what :func:`repro_torch.launch.mesh.run_ranks` runs
in every rank process: it builds the rank's mesh, the model on the rank's
device and, for each scenario, an Engine over the rank's slice of the
weights, serves the scenario's rounds of requests and returns what it
served. ``chip_smoke.py``'s ``tp_serve`` phase and the tensor-parallel
tests call it the same way::

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.tp_serve import serve_rank
    results = run_ranks(2, serve_rank, (1, 2), [scenario], backend="gloo")

A scenario is a dict: ``cfg`` (a ``ModelConfig``), ``params`` (the full
parameter tree, or the path of a ``torch.save`` of it, loaded memory-mapped
so that each rank reads only its slice), ``engine`` (``EngineConfig``
keyword arguments), ``rounds`` (lists of ``(tick, rid, prompt,
max_new_tokens)``; each round is one ``Engine.run`` on the same engine,
tick 0 submitted up front, later ticks as arrivals) and optionally
``faults`` (a ``FaultPlan``). The launch counters are set to 0 before the
last round and read after it.
"""
from __future__ import annotations

import resource
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["serve_rank", "serve_scenario", "tree_bytes"]


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_scenario(sc: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Serve one scenario on ``mesh`` (None: unsharded, on the CUDA device
    or ``sc["device"]``). Returns ``out`` ``{rid: (tokens, status)}`` over
    every round, the last round's ``stats`` (``decode_stats``), its
    kernel ``launches``, ``wall_s`` and ``output_tokens``, the pages copied
    on write, the mesh's all-reduces over the last round (``Mesh.stats``),
    the bytes of the rank's weights on its device and the process's peak
    host RSS (``ru_maxrss``: it counts the pages of memory-mapped weights
    the rank touched, which the page cache holds once for every rank)."""
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    device = mesh.device if mesh is not None else sc.get("device")
    params = sc["params"]
    if isinstance(params, str):
        params = torch.load(params, mmap=True, map_location="cpu",
                            weights_only=True)
    model = Model(sc["cfg"], device=device)
    eng = Engine(model, params, config=EngineConfig(**sc["engine"]),
                 mesh=mesh, faults=sc.get("faults"))
    del params
    out: Dict[int, Any] = {}
    rounds: Sequence = sc["rounds"]
    wall = 0.0
    for i, rnd in enumerate(rounds):
        arrivals = []
        for tick, rid, prompt, budget in rnd:
            req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=budget)
            if tick:
                arrivals.append((tick, req))
            else:
                eng.submit(req)
        if i == len(rounds) - 1:
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            for mod in (tda, dmm, smm):
                mod.reset_launch_counts()
            if mesh is not None:
                mesh.stats.update(calls=0, bytes=0, seconds=0.0)
        t0 = time.perf_counter()
        done = eng.run(arrivals=arrivals)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        wall = time.perf_counter() - t0
        out.update({r.rid: (list(map(int, r.output)), r.status)
                    for r in done})
    launches = {**tda.LAUNCHES, **dmm.LAUNCHES, **smm.LAUNCHES}
    last = {r[1] for r in rounds[-1]}
    return {
        "out": out,
        "stats": dict(eng.decode_stats),
        "launches": {k: int(v) for k, v in launches.items()},
        "wall_s": wall,
        "output_tokens": sum(len(out[rid][0]) for rid in last),
        "pages_copied": eng.slots.pages_copied,
        "collectives": dict(mesh.stats) if mesh is not None else None,
        "weight_bytes": tree_bytes(eng.params),
        "peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20,
    }


def serve_rank(mesh_shape, scenarios: List[Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
    """One rank of :func:`~repro_torch.launch.mesh.run_ranks`: build the
    ``mesh_shape`` ``(data, model)`` mesh once and serve every scenario on
    it, in order (every rank serves the same list)."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(*mesh_shape)
    return [serve_scenario(sc, mesh) for sc in scenarios]

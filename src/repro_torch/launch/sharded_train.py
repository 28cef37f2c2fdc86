"""Training on a mesh: the function each rank runs, with what the rank
measures, and a command that times a few steps:

  PYTHONPATH=src python -m repro_torch.launch.sharded_train \
      --arch qwen2.5-32b [--variant full] [--n-layers 16] [--mesh 2 2] \
      [--backend nccl|gloo] [--steps 3] [--batch 8] [--seq 64] \
      [--device cpu]

prints one JSON line per rank (step ms, the collectives' calls, host
seconds and result bytes a step, peak and predicted device bytes) and
the card's name. With ``nccl`` a collective returns once it is enqueued,
so its host seconds say little; the synchronized step ms is the measure.

:func:`train_rank` is what :func:`repro_torch.launch.mesh.run_ranks` runs
in every rank process for ``chip_smoke.py``'s ``sharded_train`` phase
(``launch/train.py`` is the user's entry point; both go through
``train/loop.py::train(mesh=)``)::

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.sharded_train import train_rank
    results = run_ranks(4, train_rank, [job], backend="gloo")

A job is a dict: ``cfg`` (a ``ModelConfig``), ``mesh`` (``(data,
model)``, ``(pod, data, model)``, or None: the rank trains alone), ``opt``
and ``loop`` (``OptConfig`` / ``TrainLoopConfig`` keyword arguments),
``batches`` (numpy batches, the whole batch of each step) and optionally
``device`` (e.g. ``"cpu"``: the rank's mesh on the CPU, whatever device
the rank has), ``init_device`` (draw the params there, e.g. ``"cpu"``,
and move them: the CPU and CUDA generators draw different numbers) and
``gather`` (return the whole params after the run). The params start
from ``Model.init(0)``, identical on every rank, and are cut to the
rank's slices before the run.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["train_rank", "predict_rank_bytes", "main"]


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def predict_rank_bytes(model, local: Dict, specs: Dict, mesh, batch_rows: int,
                       seq: int) -> Dict[str, int]:
    """A rank's predicted peak bytes while training with AdamW, f32
    masters and state: ``state`` (params, gradients, two moments: 16 B an
    entry of its slices), ``gathered`` (the largest layer's FSDP-gathered
    weights plus the gathered token table and head, f32, each with its
    f32 gradient: 8 B an entry), ``update`` (AdamW's two leaf-sized f32
    temporaries at its largest slice) and ``activations`` (the logits of
    the rank's ``batch_rows * seq`` tokens over its vocabulary block, f32,
    with their gradient, and ~40 ``(tokens, d_model)`` f32 tensors a
    layer)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.sharding import fsdp_dim
    cfg = model.cfg
    n = _numel(local)

    def gathered(tree, spec, lead=0):
        total = 0
        for path, leaf in tree_leaves(tree):
            sp = spec
            for k in path:
                sp = sp[k]
            numel = leaf.numel() // max(leaf.shape[0], 1) if lead \
                else leaf.numel()
            dim = fsdp_dim(path, sp[lead:]) if lead else fsdp_dim(path, sp)
            total += numel * (mesh.n("data") if dim is not None else 1)
        return total

    layer = gathered(local["layers"], specs["layers"],
                     lead=1 if cfg.uniform_layers else 0)
    ends = gathered(local["embed"], specs["embed"]) + gathered(
        local["lm_head"], specs["lm_head"])
    biggest = max(leaf.numel() for _, leaf in tree_leaves(local))
    tokens = batch_rows * seq
    vocab = cfg.vocab_size // mesh.n("model")
    act = tokens * vocab * 4 * 2 + 40 * cfg.n_layers * tokens \
        * cfg.d_model * 4
    out = {"state": 16 * n, "gathered": 8 * (layer + ends),
           "update": 2 * 4 * biggest, "activations": act}
    out["total"] = sum(out.values())
    return out


def train_rank(jobs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Run each job on this rank (see the module docstring). Returns per
    job: ``history`` (the loop's records), ``steps`` (per step: the
    mesh's collectives ``calls``, ``bytes`` and host ``seconds``), the
    rank's ``coords``, its device's ``peak_bytes`` over the run (CUDA
    only; counted from after the slices are made and the whole tree
    freed), ``predicted`` (:func:`predict_rank_bytes`, for AdamW on a
    mesh), the ``seconds`` of the run and, with ``gather``, the whole
    params after it (numpy, f32)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import (batch_spec, gather_tree,
                                             param_specs, shard_params)
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in jobs:
        shape = job.get("mesh")
        mesh = None
        if shape is not None:
            kw = {"device": job.get("device")}
            mesh = make_local_mesh(shape[1], shape[2], pod=shape[0], **kw) \
                if len(shape) == 3 else make_local_mesh(*shape, **kw)
        dev = mesh.device if mesh is not None else torch.device(
            job.get("device") or "cuda")
        model = Model(job["cfg"], device=dev)
        init = job.get("init_device")
        params = model.init(0) if init is None else tree_map(
            lambda t: t.to(dev), Model(job["cfg"], device=init).init(0))
        predicted = specs = None
        if mesh is not None and mesh.size > 1:
            specs = param_specs(params, mesh)
            params = tree_map(lambda t: t.clone(),
                              shard_params(params, specs, mesh))
            b0 = job["batches"][0]
            rows = batch_spec(b0, mesh)["inputs"][0]
            n_rows = b0["inputs"].shape[0] // (
                1 if rows is None else int(np.prod(
                    [mesh.n(a) for a in (rows if isinstance(rows, tuple)
                                         else (rows,))])))
            predicted = predict_rank_bytes(model, params, specs, mesh,
                                           n_rows, b0["inputs"].shape[1])
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        marks: List[Dict[str, float]] = []

        def hook(step, batch, marks=marks, mesh=mesh):
            if mesh is not None:
                marks.append(dict(mesh.stats))
            return batch

        t0 = time.perf_counter()
        res = train(model, iter(job["batches"]), OptConfig(**job["opt"]),
                    TrainLoopConfig(**job["loop"]), mesh=mesh,
                    params=params, specs=specs,
                    hooks={"inject_fault": hook})
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        if mesh is not None:
            marks.append(dict(mesh.stats))
        steps = [{k: b[k] - a[k] for k in a}
                 for a, b in zip(marks, marks[1:])]
        rec = {"history": res["history"], "steps": steps,
               "coords": None if mesh is None else dict(mesh.coords),
               "peak_bytes": peak, "predicted": predicted,
               "seconds": seconds}
        if job.get("gather"):
            p = res["state"]["params"]
            if res["specs"] is not None:
                p = gather_tree(p, res["specs"], mesh)
            rec["params"] = tree_map(
                lambda t: t.detach().float().cpu().numpy(), p)
        out.append(rec)
        del res, params, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> List[Dict[str, Any]]:
    """Time ``--steps`` AdamW steps of ``lm_batches`` (seed 0) on a mesh
    of ``--mesh`` ranks (``launch.mesh.run_ranks``), no checkpoint, the
    reference launcher's learning rate and warmup."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import run_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="full", choices=["smoke", "full"])
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--mesh", type=int, nargs="+", default=[2, 2])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    cfg = get_config(args.arch, args.variant, **over)
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      n_codebooks=cfg.n_codebooks)
    job = dict(cfg=cfg, mesh=tuple(args.mesh),
               opt=dict(lr=3e-3, warmup_steps=10, total_steps=args.steps),
               loop=dict(total_steps=args.steps, ckpt_dir=tempfile.mkdtemp(
                   prefix="sharded_train_"), ckpt_every=10**9, log_every=1),
               batches=[next(data) for _ in range(args.steps)])
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    ranks = run_ranks(int(np.prod(args.mesh)), train_rank, [job],
                      device=args.device, backend=backend)
    card = torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"
    for r in ranks:
        rec = r[0]
        print(json.dumps({
            "coords": rec["coords"], "backend": backend, "card": card,
            "model": cfg.name, "n_layers": cfg.n_layers, "mesh": args.mesh,
            "peak_gb": None if rec["peak_bytes"] is None
            else rec["peak_bytes"] / 1e9,
            "predicted_gb": rec["predicted"]["total"] / 1e9,
            "steps": [{"step": h["step"], "loss": h["loss"],
                       "ms": round(h["dt"] * 1e3, 3),
                       "collective_calls": st["calls"],
                       "collective_host_s": round(st["seconds"], 3),
                       "collective_gb": st["bytes"] / 1e9}
                      for h, st in zip(rec["history"], rec["steps"])],
            "seconds": round(rec["seconds"], 3)}), flush=True)
    return ranks


if __name__ == "__main__":
    main()

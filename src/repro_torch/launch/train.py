"""Training launcher (``repro.launch.train``), on one device or on a mesh
of rank processes.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
      [--variant smoke|full] [--steps 200] [--batch 8] [--seq 64] \\
      [--lr 3e-3] [--factorized] [--optimizer adamw|adafactor] \\
      [--ckpt DIR] [--mesh-data D] [--mesh-model M] [--production-mesh] \\
      [--multi-pod] [--backend nccl|gloo] [--n-layers N] \\
      [--dtype float32] [--device cpu]

The reference's flags and schedule: ``lm_batches`` of the config's
vocabulary (seed 0), ``OptConfig(name=--optimizer, lr=--lr,
warmup_steps=10, total_steps=--steps)``, a checkpoint every quarter of the
run into ``--ckpt``, and with ``--factorized`` (``min_dim`` 32 at smoke
size, 256 at full) sparse training from a third of the run.

``--mesh-data D --mesh-model M`` trains on a ``(D, M)`` mesh of ``D * M``
rank processes (``launch.mesh.run_ranks``; run from inside a process
group of that many ranks, such as one that ``torchrun`` starts, each rank
runs its part in place): the reference's placement, FSDP over ``data``,
TP over ``model`` and experts over ``data`` (``launch/sharding.py``), and
its losses. ``--production-mesh`` builds the reference's ``(16, 16)``
mesh and ``--multi-pod`` its ``(2, 16, 16)`` ``(pod, data, model)`` one;
both raise, naming the 256 or 512 ranks they need, on a run that lacks
them. ``--backend`` is ``nccl`` (one card per rank; more ranks than cards
raise) or ``gloo`` (ranks on the CPU, or sharing a card); the default is
``nccl`` on CUDA and ``gloo`` with ``--device cpu``. A ``(1, 1)`` mesh
trains as no mesh.

Plus the port's ``--n-layers`` (cut the depth: the full 64-layer
qwen2.5-32b's train state does not fit one card), ``--dtype`` (the
config's compute dtype, e.g. ``float32``) and ``--device`` (default: the
CUDA device). Serve the result with ``python -m repro_torch.launch.serve
--ckpt DIR``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.data import lm_batches
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     production_mesh_shape, run_ranks)
from repro_torch.models.transformer import Model
from repro_torch.optim import OptConfig
from repro_torch.train import TrainLoopConfig, train


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--factorized", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt", default="checkpoints")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


def _mesh(args):
    """This rank's mesh (None: no mesh)."""
    kw = dict(device=args.device, backend=args.backend)
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod, **kw)
    if args.mesh_data * args.mesh_model == 1:
        return None
    return make_local_mesh(args.mesh_data, args.mesh_model, **kw)


def _run(args):
    """One rank's run (every rank of the mesh runs it)."""
    mesh = _mesh(args)
    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    if args.dtype is not None:
        over["dtype"] = args.dtype
    cfg = get_config(args.arch, args.variant, **over)
    if args.factorized:
        cfg = dataclasses.replace(
            cfg, factorization=FactorizationConfig(
                enabled=True, min_dim=32 if args.variant == "smoke" else 256))
    model = Model(cfg, device=args.device if mesh is None else mesh.device)
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      n_codebooks=cfg.n_codebooks)
    out = train(
        model, data,
        OptConfig(name=args.optimizer, lr=args.lr, warmup_steps=10,
                  total_steps=args.steps),
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=max(args.steps // 4, 1),
                        sparse_from_step=args.steps // 3
                        if args.factorized else 10**9),
        mesh=mesh)
    if mesh is None or mesh.coords == {a: 0 for a in mesh.axis_names}:
        print(f"done: final loss {out['history'][-1]['loss']:.4f}, "
              f"checkpoints in {args.ckpt}")
    return out


def _ranks(args) -> int:
    if args.production_mesh or args.multi_pod:
        return production_mesh_shape(args.multi_pod).size
    return args.mesh_data * args.mesh_model


def main(argv=None):
    args = _parse(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    n = _ranks(args)
    if n == 1 or (dist.is_initialized() and dist.get_world_size() == n):
        return _run(args)
    if args.production_mesh or args.multi_pod:
        _mesh(args)  # raises, naming the ranks the mesh needs
    return run_ranks(n, _run, args, device=args.device,
                     backend=args.backend)[0]


if __name__ == "__main__":
    main()

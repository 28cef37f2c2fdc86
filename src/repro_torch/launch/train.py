"""Training launcher (``repro.launch.train``) on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
      [--variant smoke|full] [--steps 200] [--batch 8] [--seq 64] \\
      [--lr 3e-3] [--factorized] [--optimizer adamw|adafactor] \\
      [--ckpt DIR] [--n-layers N] [--device cpu]

The reference's flags and schedule: ``lm_batches`` of the config's
vocabulary (seed 0), ``OptConfig(name=--optimizer, lr=--lr,
warmup_steps=10, total_steps=--steps)``, a checkpoint every quarter of the
run into ``--ckpt``, and with ``--factorized`` (``min_dim`` 32 at smoke
size, 256 at full) sparse training from a third of the run. Plus the
port's ``--n-layers`` (cut the depth: the full 64-layer qwen2.5-32b's
train state does not fit one card) and ``--device`` (default: the CUDA
device). The reference's mesh flags (``--mesh-data``, ``--mesh-model``,
``--production-mesh``, ``--multi-pod``) are taken for a one-device mesh
(``--mesh-data 1 [--mesh-model 1]``), which trains as no mesh, and
refused for more devices: sharded training is item 12b of the roadmap.
Serve the result with ``python -m repro_torch.launch.serve --ckpt DIR``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.data import lm_batches
from repro_torch.models.transformer import Model
from repro_torch.optim import OptConfig
from repro_torch.train import TrainLoopConfig, train


def main(argv=None):
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
    ap.add_argument("--mesh-data", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    # A one-device mesh is no mesh (the reference's serving rule,
    # ``tensor_parallel_size``): its training is the unsharded step.
    if args.mesh_data > 1 or args.mesh_model != 1 or args.production_mesh \
            or args.multi_pod:
        raise UnsupportedConfigError(
            "training on a mesh of more than one device (--mesh-data, "
            "--mesh-model, --production-mesh, --multi-pod) comes with "
            "sharded training (ROADMAP Queue 1 item 12b); the port trains "
            "on one device")

    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    cfg = get_config(args.arch, args.variant, **over)
    if args.factorized:
        cfg = dataclasses.replace(
            cfg, factorization=FactorizationConfig(
                enabled=True, min_dim=32 if args.variant == "smoke" else 256))
    model = Model(cfg, device=args.device)
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      n_codebooks=cfg.n_codebooks)
    out = train(
        model, data,
        OptConfig(name=args.optimizer, lr=args.lr, warmup_steps=10,
                  total_steps=args.steps),
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=max(args.steps // 4, 1),
                        sparse_from_step=args.steps // 3
                        if args.factorized else 10**9))
    print(f"done: final loss {out['history'][-1]['loss']:.4f}, "
          f"checkpoints in {args.ckpt}")
    return out


if __name__ == "__main__":
    main()

"""End-to-end training driver (``examples/train_factorized_lm.py``): a
small LM, dense and then with the full T-REX schedule (dense warmup ->
factorized sparse training with the STE, the regularizer and periodic
projection), and the final losses' gap (the paper's E6, "minimal accuracy
loss", at smoke scale).

  PYTHONPATH=src python -m repro_torch.examples.train_factorized_lm \\
      [--steps 150] [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.core.tree import tree_map
from repro_torch.data import lm_batches
from repro_torch.models.transformer import Model
from repro_torch.optim import OptConfig
from repro_torch.train import TrainLoopConfig, train

OPT = OptConfig(lr=5e-3, warmup_steps=10, schedule="constant",
                weight_decay=0.0)


def run_config(arch: str, factorized: bool, dtype: Optional[str] = None):
    cfg = get_config(arch, "smoke")
    if factorized:
        cfg = dataclasses.replace(cfg, factorization=FactorizationConfig(
            enabled=True, min_dim=32))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def train_run(cfg, steps: int, ckpt_dir: str, device=None, params=None,
              sparse_from_step: Optional[int] = None,
              project_every: int = 20) -> Dict:
    """``train`` of ``cfg`` on ``lm_batches(V, 8, 32, seed=1)`` for
    ``steps`` steps (checkpoints every 50 under ``ckpt_dir``, a record
    every 25; sparse from ``steps // 3`` unless given). Returns
    ``train``'s output."""
    model = Model(cfg, device=device)
    if params is not None:
        params = tree_map(lambda t: t.to(model.device).clone(), params)
    data = lm_batches(cfg.vocab_size, batch=8, seq=32, seed=1)
    loop = TrainLoopConfig(
        total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=50, log_every=25,
        sparse_from_step=steps // 3 if sparse_from_step is None
        else sparse_from_step, project_every=project_every)
    return train(model, data, OPT, loop, params=params)


def main(argv=None, params=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint prefix (default: a temporary dir)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    results, histories = {}, {}
    with tempfile.TemporaryDirectory(prefix="trex_ckpt_") as tmp:
        prefix = args.ckpt or f"{tmp}/trex_ckpt"
        for tag, fact in (("dense", False), ("factorized", True)):
            cfg = run_config(args.arch, fact, args.dtype)
            p = None if params is None else params[tag]
            out = train_run(cfg, args.steps, f"{prefix}_{tag}", args.device,
                            params=p)
            histories[tag] = out["history"]
            results[tag] = out["history"][-1]["loss"]
            print(f"[{tag}] final loss {results[tag]:.4f}")
    gap = results["factorized"] - results["dense"]
    print(f"\nfactorized - dense = {gap:+.4f} nats "
          f"(paper claim: minimal accuracy loss)")
    return {"final": results, "gap": gap, "history": histories}


if __name__ == "__main__":
    main()

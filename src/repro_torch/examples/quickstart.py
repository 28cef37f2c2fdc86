"""Quickstart (``examples/quickstart.py``): build a factorized model,
compute the paper's headline numbers, run a forward pass and the loss.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import ema
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.core.tree import tree_map
from repro_torch.models.transformer import Model


def quickstart_config(dtype: Optional[str] = None):
    """qwen2.5-32b smoke, factorized at ``min_dim`` 32 (the smoke dims)."""
    cfg = get_config("qwen2.5-32b", "smoke", factorized=True)
    cfg = dataclasses.replace(cfg, factorization=FactorizationConfig(
        enabled=True, min_dim=32))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def quickstart_batch(cfg, seed: int = 1) -> Dict[str, np.ndarray]:
    """Two rows of 32 random token ids and labels (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
            for k in ("inputs", "labels")}


def loss_report(model, params, batch) -> Dict[str, float]:
    """One evaluation of the sparse-training loss (STE + regularizer)."""
    dev = model.device
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.no_grad():
        loss, metrics = model.loss(params, tb, sparse_train=True)
    return {"loss": float(loss), "sparsity_reg": float(
        metrics["sparsity_reg"])}


def paper_report() -> Dict[str, float]:
    """The BERT workload's EMA reductions and the chip model at 0.45 V."""
    fcfg = FactorizationConfig(enabled=True)
    w = ema.PAPER_WORKLOADS["bert"]
    r = ema.ema_report(w, fcfg)
    le = ema.latency_energy_report(w, fcfg, corner="slow")
    return {k: float(r[k]) for k in ("reduction_factorize",
                                      "reduction_compress",
                                      "reduction_batching",
                                      "reduction_total")} | {
        "us_per_token": float(le["us_per_token"]),
        "uJ_per_token": float(le["uJ_per_token"])}


def main(argv=None, params=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print("assigned architectures:", ", ".join(list_archs()))

    cfg = quickstart_config(args.dtype)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed) if params is None else tree_map(
        lambda t: t.to(model.device), params)
    print(f"\nfactorized {cfg.name}: dictionaries shared across "
          f"{cfg.n_layers} layers -> {sorted(params['dicts'])}")
    out = loss_report(model, params, quickstart_batch(cfg))
    print(f"one loss evaluation: {out['loss']:.3f} "
          f"(sparsity reg {out['sparsity_reg']:.4f})")

    r = paper_report()
    print(f"\nBERT workload EMA: factorize {r['reduction_factorize']:.1f}x "
          f"* compress {r['reduction_compress']:.2f}x "
          f"* dyn-batch {r['reduction_batching']:.2f}x "
          f"= {r['reduction_total']:.1f}x (paper: 31-65.9x)")
    print(f"chip model @0.45V: {r['us_per_token']:.0f} us/token, "
          f"{r['uJ_per_token']:.2f} uJ/token (paper: 68-567 / 0.41-3.95)")
    return {**out, **r, "dicts": sorted(params["dicts"])}


if __name__ == "__main__":
    main()

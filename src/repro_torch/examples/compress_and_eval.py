"""Offline compression pass (``examples/compress_and_eval.py``): train
briefly with the sparse schedule, project W_D, compress to the T-REX
streaming format (4-bit LUT W_S, delta-coded 6-bit W_D) and count the
exact stored bytes against fp16.

  PYTHONPATH=src python -m repro_torch.examples.compress_and_eval \\
      [--steps 80] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core import compression as comp
from repro_torch.core.factorized import FactorizationConfig
from repro_torch.core.sparsity import project_topk_columns
from repro_torch.core.tree import tree_leaves
from repro_torch.data import lm_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim import OptConfig, init_opt_state

FCFG = FactorizationConfig(enabled=True, min_dim=32)
OPT = OptConfig(lr=5e-3, warmup_steps=5, schedule="constant",
                weight_decay=0.0)


def compress_config(dtype: Optional[str] = None):
    """qwen2.5-32b smoke, factorized at ``min_dim`` 32."""
    cfg = dataclasses.replace(get_config("qwen2.5-32b", "smoke"),
                              factorization=FCFG)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def sparse_train(model, params, steps: int) -> float:
    """``steps`` AdamW steps of the sparse-training loss (STE and
    regularizer) on ``lm_batches(V, 8, 32, seed=1)``, in place; returns
    the last step's loss (nan for 0 steps)."""
    state = {"params": params, "opt": init_opt_state(params, OPT),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    step = make_train_step(model, OPT, sparse_train=True)
    data = lm_batches(model.cfg.vocab_size, 8, 32, seed=1)
    loss = float("nan")
    for _ in range(steps):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in next(data).items()}
        state, metrics = step(state, batch)
        loss = metrics["loss"]
    return float(loss)


def compress_report(params: Dict, fcfg: FactorizationConfig = FCFG
                    ) -> Dict:
    """Per W_D leaf (layer 0's matrix, projected to ``nnz`` a column and
    reordered for delta coding) its ``nnz`` and achieved delta bits; the
    fp16 bytes of every factorized leaf and dictionary against their
    compressed streams (every layer priced as layer 0)."""
    dense_bits = comp_bits = 0
    leaves: List[Dict] = []
    for path, leaf in tree_leaves(params):
        if path[-1] != "wd":
            continue
        r, d_out = leaf.shape[-2], leaf.shape[-1]
        nnz = fcfg.nnz_for(r)
        mats = leaf.detach().float().cpu().reshape(-1, r, d_out)
        stack = project_topk_columns(mats[0], nnz)
        idx = torch.sort(torch.argsort(-stack.abs(), dim=0, stable=True)
                         [:nnz], dim=0).values
        order = comp.reorder_for_delta(
            comp.delta_decode(comp.delta_encode(idx)), r)
        cwd = comp.compress_wd(stack, nnz, order=order)
        dense_bits += leaf.numel() * 16
        comp_bits += comp.wd_compressed_bits(cwd) * mats.shape[0]
        leaves.append({"leaf": "/".join(path[:-1]), "nnz": nnz,
                       "delta_bits": int(cwd.achieved_delta_bits)})
    for ws in params.get("dicts", {}).values():
        cws = comp.compress_ws(ws.detach().float().cpu())
        dense_bits += ws.numel() * 16
        comp_bits += comp.ws_compressed_bits(cws)
    return {"leaves": leaves, "dense_kib": dense_bits / 8 / 1024,
            "compressed_kib": comp_bits / 8 / 1024,
            "ratio": dense_bits / comp_bits}


def main(argv=None, params=None) -> Dict:
    """``params`` (on the device) are trained in place."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    model = Model(compress_config(args.dtype), device=args.device)
    params = model.init(args.seed) if params is None else params
    loss = sparse_train(model, params, args.steps)
    print(f"trained {args.steps} steps, loss {loss:.3f}")
    rep = compress_report(params)
    for leaf in rep["leaves"]:
        print(f"  {leaf['leaf']:40s} nnz/col={leaf['nnz']} "
              f"delta_bits={leaf['delta_bits']} (target 5)")
    print(f"factorized weights: {rep['dense_kib']:.0f} KiB (fp16) -> "
          f"{rep['compressed_kib']:.0f} KiB compressed "
          f"({rep['ratio']:.1f}x)")
    return {"loss": loss, **rep}


if __name__ == "__main__":
    main()

"""The training loop (``repro.train.loop``) on one device: checkpoint and
restart, the NaN / spike / step-timeout guard, and the paper's schedule:
dense warmup, then factorized sparse training (the straight-through top-k
projection of W_D in the forward pass plus the out-of-support L1 term)
from ``sparse_from_step``, with a hard projection of every W_D to its
fixed NZ per column every ``project_every`` sparse steps.

On the CPU its observable behaviour is the reference's: the same
``history`` and checkpoint cadence for the same data. Where the reference
relies on buffer donation, the port decides between the backward pass and
the in-place update (``launch/steps.py``): a bad step leaves the state as
it was when a checkpoint exists, and takes the updated state when none
does. Before it looks for a checkpoint the guard waits for pending
asynchronous saves, so the choice does not depend on the writer thread's
progress.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (async_save, latest_step,
                                               restore_checkpoint,
                                               wait_pending)
from repro_torch.core.factorized import (FactorizationConfig,
                                         project_wd_leaves)
from repro_torch.data.loader import to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.adamw import OptConfig, init_opt_state

__all__ = ["TrainLoopConfig", "train", "make_project_fn"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    # Fault tolerance
    nan_guard: bool = True
    max_consecutive_bad: int = 3
    step_timeout_s: float = 0.0  # 0 = off; > 0: a slower step is bad
    # Paper schedule
    sparse_from_step: int = 0  # STE projection active from this step
    project_every: int = 25  # hard top-k projection of W_D (0 = off)


def make_project_fn(fcfg: FactorizationConfig) -> Callable[[Any], Any]:
    """Hard top-k-per-column projection of every W_D leaf (any leading
    dims), :func:`~repro_torch.core.factorized.project_wd_leaves` written
    back into the tree's own tensors: returns the same tree, so whoever
    holds it (or its leaves) sees the projected W_D."""

    def copy_back(dst, src):
        for k, v in dst.items():
            if isinstance(v, dict):
                copy_back(v, src[k])
            elif k == "wd":
                v.copy_(src[k])

    def project(params):
        with torch.no_grad():
            copy_back(params, project_wd_leaves(params, fcfg))
        return params

    return project


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model, data: Iterator[Dict[str, np.ndarray]],
          opt_cfg: OptConfig, loop_cfg: TrainLoopConfig, *, seed: int = 0,
          hooks: Optional[Dict[str, Callable]] = None,
          params: Optional[Dict] = None) -> Dict[str, Any]:
    """Run (or resume) training of ``model`` on its device over numpy
    batches from ``data``. The state starts from ``params`` (default
    ``model.init(seed)``), or from the latest checkpoint in
    ``loop_cfg.ckpt_dir`` when there is one. ``hooks["inject_fault"](step,
    batch)`` may replace a batch. Returns ``{"state": {"params", "opt",
    "step"}, "history": [{"step", "loss", "dt", "grad_norm", "sparse"},
    ...]}`` (a record every ``log_every`` steps and at the last; ``dt``
    the whole step's wall seconds, synchronized)."""
    hooks = hooks or {}
    fcfg = model.cfg.factorization
    dev = model.device
    project_fn = make_project_fn(fcfg) if (
        fcfg.enabled and loop_cfg.project_every) else None
    ckpt = loop_cfg.ckpt_dir

    params = model.init(seed) if params is None else params
    state = {"params": params, "opt": init_opt_state(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if latest_step(ckpt) is not None:
        state, start_step = restore_checkpoint(ckpt, state)
        print(f"[train] resumed from step {start_step}")
    step0 = int(state["step"])

    dense_step = make_train_step(model, opt_cfg, sparse_train=False)
    sparse_step = make_train_step(model, opt_cfg, sparse_train=True)

    history = []
    bad_streak = 0
    prev_loss = None
    for step in range(step0, loop_cfg.total_steps):
        batch = next(data)
        if "inject_fault" in hooks:
            batch = hooks["inject_fault"](step, batch)
        batch = to_device(batch, dev)
        sparse = fcfg.enabled and step >= loop_cfg.sparse_from_step
        fn = sparse_step if sparse else dense_step
        _sync(dev)
        t0 = time.perf_counter()
        verdict: Dict[str, Any] = {}

        def guard(metrics, t0=t0, verdict=verdict, prev=prev_loss):
            # Reads the loss (a host sync) after the backward pass. The
            # timeout sees the step up to here: past the update, a bad
            # step could no longer leave the state as it was.
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            bad = not math.isfinite(loss)
            if prev is not None and math.isfinite(loss):
                bad |= loss > max(3.0 * prev, prev + 5.0)
            if loop_cfg.step_timeout_s and dt > loop_cfg.step_timeout_s:
                bad = True
            verdict.update(loss=loss, bad=bad)
            if not (loop_cfg.nan_guard and bad):
                return True
            wait_pending()
            return latest_step(ckpt) is None  # no checkpoint: take it

        state, metrics = fn(state, batch, guard=guard)
        _sync(dev)
        dt = time.perf_counter() - t0
        loss = verdict["loss"]

        if loop_cfg.nan_guard and verdict["bad"]:
            bad_streak += 1
            print(f"[train] step {step}: bad step (loss={loss}, "
                  f"{dt:.1f}s) — skipped "
                  f"({bad_streak}/{loop_cfg.max_consecutive_bad})")
            if bad_streak >= loop_cfg.max_consecutive_bad:
                ck = latest_step(ckpt)
                if ck is not None:
                    state, _ = restore_checkpoint(ckpt, state)
                    print(f"[train] restarted from checkpoint step {ck}")
                bad_streak = 0
            continue
        bad_streak = 0
        prev_loss = loss if prev_loss is None \
            else 0.9 * prev_loss + 0.1 * loss

        # Paper schedule: periodic hard projection of W_D.
        if project_fn is not None and sparse and \
                (step + 1) % loop_cfg.project_every == 0:
            state["params"] = project_fn(state["params"])

        if step % loop_cfg.log_every == 0 \
                or step == loop_cfg.total_steps - 1:
            rec = {"step": step, "loss": loss, "dt": dt,
                   "grad_norm": float(metrics.get("grad_norm", 0.0)),
                   "sparse": sparse}
            history.append(rec)
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {rec['grad_norm']:8.3f} {dt * 1e3:7.1f}ms"
                  f"{' [sparse]' if sparse else ''}")
        if (step + 1) % loop_cfg.ckpt_every == 0:
            async_save(ckpt, step + 1, state, keep=loop_cfg.keep)

    wait_pending()
    return {"state": state, "history": history}

"""Serving launcher: the engine over synthetic request traffic.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      [--variant full] [--n-layers 8] [--requests 8] [--max-len 64] \\
      [--max-new 8] [--serialized] [--contiguous] [--kv-quant] \\
      [--device cuda]

The reference launcher's flags, plus ``--n-layers`` (cut the depth: the
full 64-layer qwen2.5-32b does not fit one 80 GB card with f32 params),
the engine's lanes and prefill (``--serialized``: packed / chunked prefill
sweeps instead of mixed steps; ``--contiguous``: contiguous lanes instead
of page pools; ``--kv-quant``: int8 K/V lanes — the last two imply the
serialized engine) and ``--device``. Weights are random (``Model.init``,
seed 0); ``--ckpt`` is refused until checkpoints are ported. Runs on the
CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.models.transformer import Model
from repro_torch.serve import Engine, EngineConfig, Request


def request_lengths(n: int, max_len: int, seed: int = 0):
    """The reference's ``repro.data.request_lengths`` ("bert" profile):
    mostly short prompts, bucketed at max_len/8, /4, /2 and max_len."""
    rng = np.random.default_rng(seed)
    buckets = [max_len // 8, max_len // 4, max_len // 2, max_len]
    idx = rng.choice(len(buckets), size=n, p=[0.25, 0.4, 0.25, 0.1])
    jitter = rng.integers(-max_len // 16, 1, size=n)
    return [int(np.clip(buckets[i] + j, 1, max_len))
            for i, j in zip(idx, jitter)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--serialized", action="store_true")
    ap.add_argument("--contiguous", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.ckpt:
        raise UnsupportedConfigError(
            "--ckpt: checkpoint restore comes with a later slice of the "
            "port (ROADMAP Queue 1 item 12)")
    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    if args.kv_quant:
        over["kv_quant"] = True
    cfg = get_config(args.arch, args.variant, **over)
    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    eng = Engine(model, params, config=EngineConfig(
        max_len=args.max_len, max_new_tokens=args.max_new,
        prefix_share=False, paged=not args.contiguous,
        mixed=False if args.serialized else None))
    rng = np.random.default_rng(0)
    for rid, n in enumerate(request_lengths(args.requests, args.max_len)):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    ds = eng.decode_stats
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests on {model.device} | {toks} tokens "
          f"in {wall:.3f} s ({toks / max(wall, 1e-9):.1f} tok/s) | decode "
          f"slot utilization {ds['slot_utilization']:.2f} over "
          f"{ds['steps']} steps ({ds['mixed_steps']} mixed, "
          f"{len(eng.stats)} admission rounds) | "
          f"{'mixed' if eng.mixed else 'serialized'} engine, "
          f"{'paged' if eng.paged else 'contiguous'} "
          f"{'int8' if cfg.kv_quant else 'fp'} lanes")


if __name__ == "__main__":
    main()

"""Serving launcher: the engine over synthetic request traffic.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      [--variant full] [--n-layers 8] [--requests 8] [--max-len 64] \\
      [--max-new 8] [--serialized] [--contiguous] [--kv-quant] \\
      [--param-dtype bfloat16] [--dtype float32] [--ckpt DIR] \\
      [--device cuda]

Every stack the Engine serves: qwen2.5-32b, yi-34b, qwen1.5-4b,
starcoder2-15b (LayerNorm, GELU, sliding-window ring lanes), the MoE
family, dbrx-132b and arctic-480b (routed experts; arctic's parallel dense
FFN), and the recurrent stacks, mamba2-370m and recurrentgemma-2b
(phase-serialized, one request per prefill row). llava-next-mistral-7b and
musicgen-large, fed external embeddings, are refused with the Engine's
message before any weight is drawn: the Engine feeds token ids only. The
reference launcher's flags, plus ``--n-layers`` (cut the
depth: the full 64-layer qwen2.5-32b does not fit one 80 GB card with f32
params), ``--param-dtype`` (``bfloat16`` halves the weights: starcoder2-15b
at full depth, ~16 B parameters, fits one 80 GB card so),
the engine's lanes and prefill (``--serialized``: packed / chunked prefill
sweeps instead of mixed steps; ``--contiguous``: contiguous lanes instead
of page pools; ``--kv-quant``: int8 K/V lanes — the last two imply the
serialized engine), ``--dtype`` (the compute dtype) and ``--device``.
Weights are random (``Model.init``, seed 0) unless ``--ckpt DIR`` holds a
checkpoint: then its latest step is restored as the reference restores
it, first as ``{"params": ...}`` (a train state, ``launch/train.py``'s)
and else as a bare params tree, written by either package. Runs on the
CUDA device unless ``--device cpu`` is given. ``main`` returns the
Engine and its finished requests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import request_lengths
from repro_torch.models.transformer import Model
from repro_torch.serve import Engine, EngineConfig, Request


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
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    over = {} if args.n_layers is None else {"n_layers": args.n_layers}
    if args.kv_quant:
        over["kv_quant"] = True
    if args.param_dtype:
        over["param_dtype"] = args.param_dtype
    if args.dtype:
        over["dtype"] = args.dtype
    cfg = get_config(args.arch, args.variant, **over)
    econf = EngineConfig(max_len=args.max_len, max_new_tokens=args.max_new,
                         paged=not args.contiguous,
                         mixed=False if args.serialized else None)
    econf.validate(cfg)  # refuse before drawing any weight
    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    if args.ckpt and latest_step(args.ckpt) is not None:
        try:
            restored, step = restore_checkpoint(args.ckpt,
                                                {"params": params})
            params = restored["params"]
            print(f"loaded checkpoint step {step}")
        except KeyError:
            # a checkpoint of a bare params tree has no "params/" prefix
            params, step = restore_checkpoint(args.ckpt, params)
            print(f"partial restore: params only (step {step})")
    eng = Engine(model, params, config=econf)
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
          f"{'int8' if cfg.kv_quant else 'fp'} lanes | prefix hit ratio "
          f"{ds['prefix_hit_ratio']:.2f}, {ds['preemptions']} preemptions")
    return eng, done


if __name__ == "__main__":
    main()

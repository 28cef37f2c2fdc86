#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):

1. build    — compile the hand-written CUDA kernels from ``kernels/csrc``.
2. kernels  — each kernel against its plain PyTorch version (the
              ``kernels/tda/ref.py`` oracle over gathered lanes) on the
              card: the CPU tests' edge cases at small width (f32 and bf16)
              and the full-width shapes of phase 4 (bf16); max abs diff
              <= 1e-3 on the f32 outputs of attended decode rows and live
              mixed columns, exact zeros from the kernel everywhere else.
              Times each kernel (L2 flushed before every launch), its plain
              version, SDPA over the gathered lanes (``library_ms``, a
              yardstick the port never calls) and its bound (the live work
              only).
3. tokens   — float32 qwen2.5 smoke: the Engine on the kernels
              (``decode_attn="tda"``) gives the plain path's tokens
              (``decode_attn="dense"``) on the engine test's workload.
4. serve    — the main path at full width: qwen2.5-32b (d_model 5120, 40/8
              heads, d_head 128, d_ff 27648, vocab 152064; depth cut to 8
              of 64 layers), random weights from torch.Generator seed 0,
              16 greedy requests (8 up front, 8 arriving mid-run) through
              ``Engine.run``. Every request must end ``ok`` and both kernel
              launch counters must be > 0 (exactly one launch per layer per
              step of their kind).

Then the card's name and power limit, the kernels' JSON line, and last the
device JSON line. Exits nonzero with no result without a CUDA device or
outside a checkout of the repository.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-3          # max abs diff, kernel vs plain version, f32 outputs
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12      # H100 SXM f32 (no tensor cores)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def line(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=20):
    """Median per-call device time with a cold L2 (a 64 MB buffer is
    written before each call, outside the timed events)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, itemsize):
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------

def pool_case(np, rng, B, Hkv, D, ps, n, P, needed):
    """Shuffled pool pages behind a block table whose entries past each
    row's ``needed`` pages carry the FREE sentinel (== P)."""
    bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    for b in range(B):
        bt[b, needed[b]:] = P
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    return k, v, bt


def small_decode_cases(np):
    """hi <= lo rows, FREE-sentinel entries, a window; G = 2 and 5."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for ps in (8, 16):
            for window in (None, 5):
                rng = np.random.default_rng(ps + Hq)
                n, B = 4, 6
                lengths = np.array([0, 1, ps + 3, n * ps, 2 * ps, 3 * ps - 1])
                k, v, bt = pool_case(np, rng, B, Hkv, 16, ps, n, B * n + 3,
                                     [-(-int(x) // ps) for x in lengths])
                lo = np.zeros_like(lengths) if window is None \
                    else np.maximum(lengths - window, 0)
                bounds = np.stack([lo, lengths], 1).astype(np.int32)
                bounds[4] = [ps + 2, ps]  # hi <= lo
                q = rng.standard_normal((B, Hq, 16)).astype(np.float32)
                yield q, k, v, bounds, bt


def small_mixed_cases(np):
    """ci = 0 rows, n_new = 0 rows, a dead row, a window, and a ring
    narrower than the lane that wraps; G = 2 and 5."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for ps in (8, 16):
            for ring_short in (False, True):
                for window in (None, 6):
                    rng = np.random.default_rng(ps + Hq + 1)
                    n, S, B = 3, 8, 7
                    W = n * ps
                    ring = W - ps + 3 if ring_short else W
                    k, v, bt = pool_case(np, rng, B, Hkv, 16, ps, n,
                                         B * n + 2, [1] + [n] * (B - 1))
                    rows = [(0, 0), (0, 5), (7, 1), (9, 0), (ps + 2, 6),
                            (ps, S), (ring + 4, 3)]
                    q = rng.standard_normal((B, S, Hq, 16)).astype(np.float32)
                    kr = rng.standard_normal((B, S, Hkv, 16)).astype(
                        np.float32)
                    vr = rng.standard_normal((B, S, Hkv, 16)).astype(
                        np.float32)
                    yield ((q, k, v, kr, vr, np.array(rows, np.int32), bt),
                           dict(ring=ring, window=window))


def full_cases(np, cfg, num_slots, cache_len, page_size, chunk):
    """Phase 4's attention shapes: 8 slots over a pool of 8 lanes of
    ceil(cache_len / page_size) pages, G = 5, d_head 128."""
    rng = np.random.default_rng(1)
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    n = -(-cache_len // page_size)
    P = num_slots * n
    lengths = rng.integers(33, cache_len, size=num_slots)
    needed = [-(-int(x) // page_size) for x in lengths]
    k, v, bt = pool_case(np, rng, num_slots, Hkv, D, page_size, n, P, needed)
    q1 = rng.standard_normal((num_slots, Hq, D)).astype(np.float32)
    dec = (q1, k, v, np.stack([np.zeros_like(lengths), lengths],
                              1).astype(np.int32), bt)
    # mixed: three chunk rows, four decode rows and one inert row
    rows = [(0, chunk), (chunk, chunk), (200, 144), (300, 1), (150, 1),
            (520, 1), (64, 1), (90, 0)]
    rows = np.array(rows, np.int32)
    needed = [-(-int(ci + nn) // page_size) for ci, nn in rows]
    k2, v2, bt2 = pool_case(np, rng, num_slots, Hkv, D, page_size, n, P,
                            needed)
    q = rng.standard_normal((num_slots, chunk, Hq, D)).astype(np.float32)
    kr = rng.standard_normal((num_slots, chunk, Hkv, D)).astype(np.float32)
    vr = rng.standard_normal((num_slots, chunk, Hkv, D)).astype(np.float32)
    mix = (q, k2, v2, kr, vr, rows, bt2)
    return dec, mix


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    line("build", seconds=round(time.perf_counter() - t0, 3),
         kernels=sorted(build.SOURCES),
         ptxas={n: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln] for n, v in log.items()})


def phase_kernels(torch, np, full_cfg, engine_kw):
    import torch.nn.functional as F
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_reference,
                                             mixed_attention_reference)
    dev = torch.device("cuda")

    def T(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dt is None or x.dtype == torch.int32 else x.to(dt)

    # Plain versions: the ref.py oracle over gathered lanes. Each kernel is
    # compared on what it must compute (attended decode rows, live mixed
    # columns) and must write exact zeros elsewhere.
    def plain_decode(q, k, v, bounds, bt):
        hi, lo = bounds[:, 1:].long(), bounds[:, :1].long()
        return decode_attention_reference(q, gather(k, bt), gather(v, bt), hi,
                                          window=hi - lo)

    def plain_mixed(q, k, v, kr, vr, bounds, bt, **kw):
        return mixed_attention_reference(q, gather(k, bt), gather(v, bt), kr,
                                         vr, bounds[:, 0], bounds[:, 1], **kw)

    def check(name, got, plain, live):
        e = (got - plain)[live].abs().max().item()
        err[name] = max(err[name], e)
        if e > TOL or got[~live].any().item():
            fail(f"{name} vs plain: max abs diff {e} (limit {TOL}); zeros "
                 f"outside the live part: {not got[~live].any().item()}")

    err = {"tda_paged_decode_attention": 0.0, "tda_mixed_attention": 0.0}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for case in small_decode_cases(np):
            args = [T(a, dt) for a in case]
            live = args[3][:, 1] > args[3][:, 0]
            check("tda_paged_decode_attention",
                  tda.tda_paged_decode_attention(*args), plain_decode(*args),
                  live)
            n_cases += 1
        for case, kw in small_mixed_cases(np):
            args = [T(a, dt) for a in case]
            live = torch.arange(args[0].shape[1], device=dev)[None] \
                < args[5][:, 1:]
            check("tda_mixed_attention", tda.tda_mixed_attention(*args, **kw),
                  plain_mixed(*args, **kw), live)
            n_cases += 1
    torch.cuda.synchronize()
    line("kernels_small", cases=n_cases, max_abs_err=err)

    # Full-width shapes of phase 4, bf16 as the main path runs them.
    bf = torch.bfloat16
    cache_len = engine_kw["max_len"] * 2 + engine_kw["max_new_tokens"]
    dec, mix = full_cases(np, full_cfg, engine_kw["num_slots"],
                          cache_len, 128, engine_kw["max_len"])
    Hq, Hkv, D = full_cfg.n_heads, full_cfg.kv_heads, full_cfg.head_dim
    rows = []

    # --- paged decode: every slot attends [0, length); all rows live.
    q, k, v, bounds, bt = [T(a, bf) for a in dec]
    got = tda.tda_paged_decode_attention(q, k, v, bounds, bt)
    check("tda_paged_decode_attention", got, plain_decode(q, k, v, bounds, bt),
          bounds[:, 1] > bounds[:, 0])
    lens = dec[3][:, 1] - dec[3][:, 0]
    kv_b = int(lens.sum()) * Hkv * D * 2 * 2
    nbytes = kv_b + q.numel() * 2 + got.numel() * 4 + bounds.numel() * 4 \
        + bt.numel() * 4
    flops = 4 * int(lens.sum()) * Hq * D
    bms, by = bound(nbytes, flops, 2)
    kl, vl = gather(k, bt), gather(v, bt)
    pos = torch.arange(kl.shape[1], device=dev)
    mask = ((pos[None] >= bounds[:, :1]) & (pos[None] < bounds[:, 1:]))
    sq, sk, sv = q[:, :, None], kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3)
    smask = mask[:, None, None, :]
    rows.append({
        "name": "tda_paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tda_paged_decode.cu",
        "replaces": "src/repro/kernels/tda/tda.py:220",
        "ms": time_ms(torch, lambda: tda.tda_paged_decode_attention(
            q, k, v, bounds, bt)),
        "plain_ms": time_ms(torch, lambda: plain_decode(q, k, v, bounds, bt)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask, enable_gqa=True)),
        "bound_ms": bms, "bound_by": by,
        "shape": {"B": int(q.shape[0]), "Hq": Hq, "Hkv": Hkv, "D": D,
                  "page_size": int(k.shape[1]), "pool_pages": int(k.shape[0]),
                  "tokens_attended": int(lens.sum()), "dtype": "bfloat16"}})

    # --- mixed step
    q, k, v, kr, vr, bnd, bt = [T(a, bf) for a in mix]
    ring = cache_len
    S = q.shape[1]
    cols = torch.arange(S, device=dev)
    got = tda.tda_mixed_attention(q, k, v, kr, vr, bnd, bt, ring=ring)
    check("tda_mixed_attention", got,
          plain_mixed(q, k, v, kr, vr, bnd, bt, ring=ring),
          cols[None] < bnd[:, 1:])
    # The bound counts the live work only: a row's cache keys are read only
    # when it has a live column (n_new > 0), and only live columns' queries
    # and outputs count. The kernel's zero-writes of unread columns are its
    # own cost, not the function's.
    ci, nn = mix[5][:, 0].astype(np.int64), mix[5][:, 1].astype(np.int64)
    cache_keys = np.where(nn > 0, np.minimum(ci, ring), 0)
    keys = int((nn * cache_keys + nn * (nn + 1) // 2).sum())  # per live column
    flops = 4 * keys * Hq * D
    live_cols = int(nn.sum())
    nbytes = (int(cache_keys.sum()) + live_cols) * Hkv * D * 2 * 2 \
        + live_cols * Hq * D * (2 + 4) + bnd.numel() * 4 + bt.numel() * 4
    bms, by = bound(nbytes, flops, 2)
    kl, vl = gather(k, bt), gather(v, bt)
    r = torch.arange(kl.shape[1], device=dev)
    cit, nnt = bnd[:, :1].long(), bnd[:, 1:].long()
    cmask = (r[None] < torch.clamp(cit, max=ring))[:, None, :].expand(-1, S,
                                                                      -1)
    rmask = (cols[None, :, None] >= cols[None, None, :]) & \
        (cols[None, None, :] < nnt[:, :, None])
    fmask = torch.cat([cmask, rmask], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
    vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
    sq = q.permute(0, 2, 1, 3)
    rows.append({
        "name": "tda_mixed_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tda_mixed.cu",
        "replaces": "src/repro/kernels/tda/tda.py:391",
        "ms": time_ms(torch, lambda: tda.tda_mixed_attention(
            q, k, v, kr, vr, bnd, bt, ring=ring)),
        "plain_ms": time_ms(torch, lambda: plain_mixed(
            q, k, v, kr, vr, bnd, bt, ring=ring), reps=5),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            sq, keys_all, vals_all, attn_mask=fmask[:, None],
            enable_gqa=True)),
        "bound_ms": bms, "bound_by": by,
        "shape": {"B": int(q.shape[0]), "S": int(S), "Hq": Hq, "Hkv": Hkv,
                  "D": D, "rows_ci_nnew": mix[5].tolist(),
                  "live_columns": live_cols, "bound_bytes": nbytes,
                  "live_query_key_pairs_per_head": keys, "dtype": "bfloat16"}})
    for row in rows:
        row["max_abs_err"] = err[row["name"]]
    torch.cuda.synchronize()
    line("kernels_full", **{r["name"]: {k: r[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err", "shape")} for r in rows})
    return rows


def phase_tokens(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    import numpy as np
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    model = Model(cfg)
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    lengths, budgets, ticks = [5, 25, 12, 18], [6, 5, 4, 6], [1, 1, 3, 6]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    checked = []
    for budget in (4, 16, None):
        outs = {}
        for mode in ("tda", "dense"):
            eng = Engine(model, params, config=EngineConfig(
                max_len=16, max_new_tokens=8, num_slots=3, max_prompt_len=40,
                prefix_share=False, prefill_budget=budget, decode_attn=mode))
            reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                    for i, (p, b) in enumerate(zip(prompts, budgets))]
            tda.reset_launch_counts()
            done = eng.run(arrivals=list(zip(ticks, reqs)))
            if mode == "tda" and not all(tda.LAUNCHES.values()):
                fail(f"tda engine did not launch both kernels: {tda.LAUNCHES}")
            if sorted(r.rid for r in done) != [0, 1, 2, 3] or \
                    any(r.status != "ok" for r in done):
                fail(f"smoke run ({mode}) did not finish all requests ok")
            outs[mode] = {r.rid: list(r.output) for r in done}
        if outs["tda"] != outs["dense"]:
            fail(f"tokens differ, kernels vs plain path (budget {budget}): "
                 f"{outs}")
        checked.append(budget)
    line("tokens", float32_smoke_identical=True, prefill_budgets=checked,
         tokens=sum(len(v) for v in outs["tda"].values()))


def phase_serve(torch, np, full_cfg, engine_kw):
    from repro_torch.kernels.tda import tda
    from repro_torch.launch.profile_serve import workload
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    model = Model(full_cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    eng = Engine(model, params, config=EngineConfig(prefix_share=False,
                                                    **engine_kw))
    del params  # the engine keeps its compute-dtype copy
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm, up_front, arrivals, lengths = workload(
        full_cfg.vocab_size, engine_kw["max_new_tokens"])
    # Warm-up: one short request (library initialisation, first launches).
    eng.submit(warm)
    eng.run()
    for r in up_front:
        eng.submit(r)
    torch.cuda.synchronize()
    tda.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tda.LAUNCHES)
    st = eng.decode_stats
    if sorted(r.rid for r in done) != list(range(16)):
        fail("not every request came back")
    bad = [(r.rid, r.status, r.status_reason) for r in done
           if r.status != "ok"]
    if bad:
        fail(f"requests not ok: {bad}")
    if any(len(r.output) != engine_kw["max_new_tokens"]
           or not all(0 <= t < full_cfg.vocab_size for t in r.output)
           for r in done):
        fail("a request's output has the wrong length or an invalid token")
    L = full_cfg.n_layers
    n_dec = st["steps"] - st["mixed_steps"]
    if launches["tda_paged_decode_attention"] != L * n_dec or \
            launches["tda_mixed_attention"] != L * st["mixed_steps"] or \
            not all(launches.values()):
        fail(f"launch counts {launches} != {L} layers x ({n_dec} decode, "
             f"{st['mixed_steps']} mixed) steps")
    ttft = sorted(v["wall_s"] for v in st["ttft"].values())
    toks = sum(len(r.output) for r in done)
    line("serve", model=full_cfg.name, d_model=full_cfg.d_model,
         n_layers=L, reduced={"n_layers": "64 -> 8 (depth only)"},
         requests=len(done), ok=len(done), output_tokens=toks,
         prompt_tokens=int(lengths.sum()), wall_s=wall, setup_s=setup_s,
         output_tok_s=toks / wall,
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p99_s=float(np.percentile(ttft, 99)),
         decode_step_ms_median=float(np.median(st["step_ms"]["decode"])),
         mixed_step_ms_median=float(np.median(st["step_ms"]["mixed"])),
         steps=st["steps"], mixed_steps=st["mixed_steps"],
         slot_utilization=st["slot_utilization"],
         kv_memory_ratio=st["kv_memory_ratio"], launches=launches,
         launches_per_decode_step=L, launches_per_mixed_step=L,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.profile_serve import ENGINE_KW, serve_config
    full_cfg, engine_kw = serve_config(), ENGINE_KW

    phase_build()
    rows = phase_kernels(torch, np, full_cfg, engine_kw)
    phase_tokens(torch)
    launches = phase_serve(torch, np, full_cfg, engine_kw)
    for r in rows:
        r["launches"] = launches[r["name"]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (one line each, with its seconds; any failure exits nonzero):

1. build    — compile the hand-written CUDA kernels from ``kernels/csrc``
              (one nvcc per source, all started together); report ptxas's
              registers, shared memory and spills, and fail unless the SASS
              (``cuobjdump -sass``) of DMM holds wgmma (HGMMA, M > 32) and
              mma.sync (HMMA, M <= 32), that of SMM wgmma (M > 32) and that
              of the mixed kernel mma.sync instructions.
2. kernels  — each kernel against its plain PyTorch version on the card.
              TDA (phase ``kernels``): the ``kernels/tda/ref.py`` oracle
              (over gathered lanes for the paged kernels; with the LUT exp,
              the blockwise LUT recurrence ``decode_attention_lut`` /
              ``mixed_attention_lut``), on the CPU tests' edge cases at small
              width (f32 and bf16; contiguous lanes of ragged widths 37, 48,
              130 with LUT blocks of 16 and 128 positions; pages of 8 and 16;
              hi <= lo rows, windows, FREE block-table entries; int8 codes
              with f32 scales for all three kernels), the decode kernels'
              split edges (``SPLIT_EDGES``: G 1, 2, 5, 8; D 20, 64, 128; one
              slot over lanes of up to 64 splits, 64 slots over lanes of
              one or two; hi and lo on split and page edges, windows across
              a split; pages of 128 and 16; f32 and bf16) and the full-width
              shapes of phase 4 (bf16, and int8 K/V with bf16 queries; exact
              and LUT exp, contiguous LUT blocks at the reference's block_k
              128), and the tile edges of the tensor-core mixed body
              (``kernels_tile_edges``: G 1, 2, 5, 8; D 16, 20, 72, 128;
              pages of 8, 16, 128; S G no multiple of 64; n_new 0, 1, S;
              windows, short rings; bf16 and int8, exact and LUT); max abs
              diff on the f32 outputs of attended decode rows
              and live mixed columns <= 1e-3 with the exact exp and <= 1e-5
              with the LUT exp, exact zeros from the kernel everywhere else.
              Negative controls at full width, which must miss the LUT plain
              version by more than 1e-5: the exact-exp kernel's output, and
              LUT blocks of 64 positions (the contiguous kernel at block_k 64
              over the same codes; the mixed step's plain version on 64-key
              blocks). AFU (phase ``afu``): softmax_lut at (256, 512) (the
              kernel table's), (320, 544) (decode scores of 8 slots x 40
              heads), (8, 152064) (the LM head's rows, too long for shared
              memory) and ragged edges, within 1e-5 x |plain| per element
              (the exact-exp softmax must miss it); layernorm_residual at
              (40, 64), (8, 5120), (2048, 5120) and a ragged edge, within
              1e-5 x max(1, max |plain|); f32 and bf16 inputs. DMM and SMM
              (phase ``linear_kernels``): the CPU tests' edge cases (f32 and
              bf16 x), the tensor-core DMM body's tile edges (bf16 x; M 33,
              64, 130, 2048; N 200, 640, 3200; odd K, K no multiple of 64,
              split K), the small-M DMM body's edges (``DMM_SMALL_EDGES``:
              M 1, 7, 8, 16, 31, 32; odd K, K 27648; N 48, 200, 640, 3200),
              the edges of SMM's small-M and tensor-core bodies
              (``SMM_TILE_EDGES``: M 1, 7, 8, 31, 32, 33, 130, 2048; N
              1000, 1024, 5120, 27648; r 640, 650, 3200; nnz 1, 2, 80, 400;
              uint8 deltas with repeated indices, int16 deltas with negative
              ones) — each edge launched twice, which must give the same
              bits, its launches counted by body — and every linear family
              of qwen2.5-32b at full width at M = 8 (a decode step) and
              M = 2048 (a mixed step); max abs diff <= 1e-3 x max(1, max
              |plain|) (f32 sums in another order over K up to 27648; the
              tensor-core bodies' bf16 parts stay within 2^-16 of each
              term). Times each kernel (L2 flushed before every
              launch), its plain version, one PyTorch call computing the same
              function (``library_ms``: SDPA over the (gathered) lanes — for
              int8 lanes over lanes dequantized to bf16 beforehand, the
              dequantization untimed; exact exp beside the LUT rows —,
              ``torch.softmax`` (exact exp: the same traffic, not the same
              function), add + ``F.layer_norm``, or ``torch.matmul`` against
              the densified matrix in f32 (TF32 off; DMM and SMM also time
              the bf16 product on the bf16-rounded matrix,
              ``library_bf16_ms``, a single-pass, lower-precision product);
              a yardstick the port never calls) and its bound; the eight
              decode rows, the DMM and SMM rows at both M, and their
              yardsticks also by their kernels' device time alone
              (``device_ms``, ``library_device_ms``: ``torch.profiler``
              intervals, without the host dispatch that the events of
              ``ms`` include).
   kernel_table — the slice's entry point, ``python -m repro_torch.launch.
              kernel_table``: the reference's ``kernels`` and ``decode_attn``
              tables in-process on the card (DMM, SMM, LUT softmax, int8
              contiguous decode). Every row must carry the reference's name
              and a finite time, each kernel's output in the tables must
              match its plain version on the same inputs (the limits above),
              and the LUT softmax must stay within 5e-3 of the exact one (the
              reference test's bound).
3. tokens   — float32 qwen2.5 smoke: the mixed Engine on the TDA kernels
              gives the plain path's tokens (``decode_attn="dense"``); the
              phase-serialized Engine over contiguous and over paged lanes
              gives the plain path's tokens and the mixed Engine's; with
              int8 ``kv_quant`` lanes, contiguous and paged give the same
              tokens as each other and as the plain path; and the compressed
              smoke Engine on the DMM/SMM kernels gives the tokens of the
              same Engine over the explicitly decompressed factors (plain
              ``(x @ ws) @ wd``).
4. serve    — the main path at full width: qwen2.5-32b (d_model 5120, 40/8
              heads, d_head 128, d_ff 27648, vocab 152064; depth cut to 8
              of 64 layers), random weights from torch.Generator seed 0,
              16 greedy requests (8 up front, 8 arriving mid-run) through
              ``Engine.run`` of the mixed-step engine; then, on the same
              params, through three phase-serialized engines: contiguous
              bf16 lanes, contiguous int8 lanes, and the default ``kv_quant``
              engine (paged int8 lanes). Every request must end ``ok`` with
              ``max_new_tokens`` valid tokens, and each TDA kernel must
              launch exactly once per layer per step of its kind (zero times
              in engines that do not run it).
5. compressed — the same model factorized (T-REX defaults: rank 0.625,
              nnz 0.125 of the rank), its f32 weights drawn on the card,
              W_D projected and the whole tree compressed on the card, then
              the same 16 requests through ``Engine.run`` on the streams.
              Every request must end ``ok``, DMM and SMM must each launch 7
              x 8 times per step (every linear of every layer): decode steps
              through their small-M bodies, mixed steps through their
              tensor-core bodies, none through the CUDA-core fallbacks
              (``BODY_LAUNCHES``), and the TDA counts keep phase 4's
              invariants.

Each kernels-line row takes its launches from the run that drives it, and
names that run in ``launches_from``: the TDA rows from the phase-4 serves
(``serve:<engine>``; int8 rows from the int8 serves), DMM and SMM from phase
5 (``compressed_serve``), softmax_lut from the kernel_table phase
(``kernel_table``); layernorm_residual and the TDA LUT and int8-mixed
variants, which no serve runs, from their check at the row's full-width
shape in phase 2 (``check``: the one launch at that shape, two for
LayerNorm's f32 and bf16 inputs; counted before they are timed). Then the
card's name and power limit, the kernels' JSON line, and last the device
JSON line. Exits nonzero with no result without a CUDA device or outside a
checkout of the repository.
"""
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-3          # max abs diff, exact-exp TDA kernels vs plain version
# The LUT-exp and AFU kernels compute their plain versions' f32 formulas,
# summed in another order (on the card: <= 5.4e-7 for the LUT TDA rows,
# 3.0e-7 for softmax, 2.9e-6 for LayerNorm at outputs of up to ~20), so
# their limits sit far below the differences that a wrong kernel makes:
# the negative controls below must fail these limits on the same inputs.
LUT_TOL = 1e-5      # max abs diff, LUT TDA kernels vs blockwise LUT plain
SOFTMAX_RTOL = 1e-5  # max |diff| / |plain| per element (entries ~1e-12..1)
LN_TOL = 1e-5       # max abs diff / max(1, max |plain|), LayerNorm
LUT_CONTROL_BLOCK = 64  # a partition other than the reference's (128)
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


def device_ms(torch, fn, reps=20):
    """Median device time of the kernels one call launches: the kernels'
    intervals in a ``torch.profiler`` trace, summed per call, with a cold
    L2 as in :func:`time_ms` (the 64 MB buffer is inverted before each
    call; its kernel, the only ``bitwise_not`` in the trace, separates the
    calls). Unlike :func:`time_ms` it leaves out the host's dispatch, which
    dominates calls of tens of microseconds. A trace that comes back without
    the calls' kernels (the profiler's device tracing now and then returns
    none) is taken again, up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        calls = []
        for a, b, name in kernels:
            if "bitwise_not" in name.lower():
                calls.append(0.0)
            elif calls:
                calls[-1] += (b - a) / 1e3
        if len(calls) == reps and all(calls):
            calls.sort()
            return calls[len(calls) // 2]
    fail(f"device_ms: {len(calls)} calls with kernels in the trace, "
         f"expected {reps}, in three traces")


def rel_err(got, plain):
    """max |got - plain| / |plain| per element (LUT softmax: every entry
    is positive, down to table[0] / row sum)."""
    return ((got - plain).abs() / plain.abs()).max().item()


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


# Split edges of the decode kernels (split-K over the key axis), as
# tests/test_torch_tda.py::SPLIT_EDGES: (G, D, B), with one slot over a
# long lane (many splits) and 64 slots over short lanes (one or few); D 20
# stages bf16 and int8 rows by element copies.
SPLIT_EDGES = [(1, 64, 1), (2, 128, 64), (5, 128, 1), (8, 64, 64),
               (5, 128, 8), (2, 20, 8)]


def split_edge_rows(np, rng, W, L, B):
    """[lo, hi) rows at a lane of W positions cut into splits of L: many
    splits, hi <= lo, one token, hi and lo on split edges, a window across
    a split edge, the whole lane, the last position; then random rows."""
    rows = [(5, W - 7), (L + 2, L), (0, 1), (0, L), (L, 2 * L),
            (L - 3, 2 * L + 5), (0, W), (W - 1, W), (L - 1, L + 1), (0, 0)]
    rows = [(min(a, W), min(b, W)) for a, b in rows]
    while len(rows) < B:
        lo = int(rng.integers(0, W))
        rows.append((lo, int(rng.integers(lo, W + 1))))
    return np.array(rows[:B], np.int32)


def small_decode_cases(np):
    """hi <= lo rows, FREE-sentinel entries, a window; G = 2 and 5; then
    the split edges (SPLIT_EDGES)."""
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
    # split edges: 128-token pages (half a page a split) and 16-token
    # pages (four pages a split); one slot over a long lane, 64 slots over
    # short ones
    from repro_torch.kernels.tda.tda import decode_split_plan
    for i, (G, D, B) in enumerate(SPLIT_EDGES):
        rng = np.random.default_rng(60 + i)
        for ps, n in ((128, 32 if B == 1 else 2), (16, 64 if B == 1 else 4)):
            W = n * ps
            bounds = split_edge_rows(np, rng, W, decode_split_plan(W, ps), B)
            k, v, bt = pool_case(np, rng, B, 2, D, ps, n, B * n + 3,
                                 [-(-int(x) // ps) for x in bounds[:, 1]])
            q = rng.standard_normal((B, 2 * G, D)).astype(np.float32)
            yield q, k, v, bounds, bt


def small_contig_cases(np):
    """Contiguous lanes of ragged widths (no multiple of 32 or 128): an
    empty lane, one token, a partial and a full lane, a hi <= lo row, a
    window; G = 2 and 5; then the split edges (SPLIT_EDGES)."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for S in (37, 48, 130):
            for window in (None, 5):
                rng = np.random.default_rng(S + Hq)
                B = 6
                lengths = np.array([0, 1, S // 2 + 3, S, 7, S - 2])
                lo = np.zeros_like(lengths) if window is None \
                    else np.maximum(lengths - window, 0)
                bounds = np.stack([lo, lengths], 1).astype(np.int32)
                bounds[4] = [9, 7]  # hi <= lo
                q = rng.standard_normal((B, Hq, 16)).astype(np.float32)
                k = rng.standard_normal((B, S, Hkv, 16)).astype(np.float32)
                v = rng.standard_normal((B, S, Hkv, 16)).astype(np.float32)
                yield q, k, v, bounds
    # split edges: one slot over a long lane (63 splits), 64 slots over
    # lanes of one or two splits
    from repro_torch.kernels.tda.tda import decode_split_plan
    for i, (G, D, B) in enumerate(SPLIT_EDGES):
        rng = np.random.default_rng(70 + i)
        for S in ((4000, 544) if B == 1 else (64, 100)):
            bounds = split_edge_rows(np, rng, S, decode_split_plan(S), B)
            q = rng.standard_normal((B, 2 * G, D)).astype(np.float32)
            k = rng.standard_normal((B, S, 2, D)).astype(np.float32)
            v = rng.standard_normal((B, S, 2, D)).astype(np.float32)
            yield q, k, v, bounds


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


# Tile edges of the tensor-core mixed kernel (bf16 q, 64 packed query rows
# a block), as tests/test_torch_tda.py::MIXED_TILE_EDGES: (G, D, page_size)
# with S = 20 columns (S G no multiple of 64); D 16, 72 (int8 rows in
# 8-byte copies), 128 and 20 (element copies); pages of 8, 16 and 128.
MIXED_TILE_EDGES = [(1, 16, 8), (2, 72, 16), (5, 128, 128), (8, 16, 128),
                    (8, 72, 8), (5, 16, 16), (1, 128, 16), (2, 20, 16)]


def mixed_tile_cases(np):
    """Rows (ci, n_new): dead, a fresh full chunk, a decode row, an inert
    row, a full chunk over a resident lane, a lane past its ring (wraps
    when the ring is short) and a mid-lane chunk; windows None and 7."""
    for i, (G, D, ps) in enumerate(MIXED_TILE_EDGES):
        for ring_short in (False, True):
            rng = np.random.default_rng(20 + i)
            n = 2 if ps == 128 else 3
            S, B, Hkv = 20, 7, 2
            W = n * ps
            ring = W - ps + 3 if ring_short else W
            P = B * n + 3
            bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
            k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
            v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
            rows = np.array([(0, 0), (0, S), (W // 2, 1), (W // 3, 0),
                             (W - S, S), (ring + 5, 3), (ps + 2, S // 2 + 3)],
                            np.int32)
            q = rng.standard_normal((B, S, G * Hkv, D)).astype(np.float32)
            kr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            vr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for window in (None, 7):
                yield ((q, k, v, kr, vr, rows, bt),
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


# DMM / SMM edge cases of tests/test_torch_dmm_smm.py: (M, K, N) and
# (M, r, N, nnz, value_bits); odd K, ragged tiles, nnz = 2, int16 deltas
# (r = 1024, nnz = 2), value widths 4/5/7.
DMM_SMALL = [(32, 64, 48), (64, 128, 96), (100, 60, 36), (32, 33, 16),
             (16, 256, 128), (128, 128, 128), (8, 64, 40)]
# Tile edges of the tensor-core DMM body (bf16 x, M > 32; 128 x 128 outputs,
# K steps of 64), as tests/test_torch_dmm_smm.py::DMM_TILE_EDGES: ragged M
# and N (200: element copies), odd K, K no multiple of 64, split K.
DMM_TILE_EDGES = [(33, 127, 200), (64, 4000, 640), (130, 513, 3200),
                  (2048, 5120, 640), (2048, 2088, 200), (130, 1000, 200),
                  (2048, 1000, 3200)]
SMM_SMALL = [(32, 64, 48, 8, 6), (64, 128, 100, 16, 6), (16, 32, 32, 2, 6),
             (48, 96, 64, 24, 6), (8, 1024, 40, 2, 6), (32, 64, 48, 8, 4),
             (32, 64, 48, 8, 5), (32, 64, 48, 8, 7)]
# Edges of SMM's two redesigned bodies, as tests/test_torch_dmm_smm.py::
# SMM_TILE_EDGES: (M, r, N, nnz, kind). M 1-32 runs the small-M gather
# body, M > 32 the tensor-core body (uint8) or the first version's (int16);
# N 1000 ragged, r 650 no multiple of the 64-row K tile, nnz 1, 2, 80,
# 400; "dup": uint8 deltas with zeros, "neg": int16 deltas, some negative.
SMM_TILE_EDGES = [(1, 640, 1024, 80, "sorted"), (7, 3200, 5120, 400, "sorted"),
                  (8, 3200, 27648, 400, "sorted"), (31, 650, 1000, 2, "sorted"),
                  (32, 3200, 1024, 1, "sorted"), (8, 640, 1024, 80, "dup"),
                  (8, 640, 1000, 80, "neg"), (33, 640, 5120, 80, "sorted"),
                  (130, 3200, 1000, 400, "sorted"), (130, 640, 1024, 80, "dup"),
                  (130, 640, 1024, 80, "neg"),
                  (2048, 650, 1024, 2, "sorted"),
                  (2048, 3200, 5120, 400, "sorted")]
# Edges of DMM's small-M body (bf16 x, M <= 32), as tests/test_torch_dmm_
# smm.py::DMM_SMALL_EDGES: (M, K, N); odd K, K 27648, N 640, 3200, ragged.
DMM_SMALL_EDGES = [(1, 27648, 3200), (7, 5121, 640), (8, 27648, 640),
                   (31, 333, 3200), (32, 27648, 3200), (8, 4000, 200),
                   (16, 127, 48)]


def smm_edge_streams(np, rng, r, N, nnz, kind):
    """(first, deltas, vq) numpy streams, as tests/test_torch_dmm_smm.py::
    smm_edge_streams: uint8 deltas ("dup": a third of them 0) from a first
    index of -2 up, running past r; "neg": int16 deltas, a tenth negative."""
    first = rng.integers(-2, max(1, r // 4), size=N).astype(np.int32)
    hi = max(1, min(255, 2 * r // max(nnz, 1)))
    d = rng.integers(0, hi + 1, size=(max(nnz - 1, 0), N))
    if kind == "dup":
        d[rng.random(d.shape) < 1 / 3] = 0
    if kind == "neg":
        d[rng.random(d.shape) < 0.1] -= 20
    vq = rng.integers(0, 64, size=(nnz, N)).astype(np.uint8)
    return first, d.astype(np.int16 if kind == "neg" else np.uint8), vq


def wd_streams(torch, wd, nnz, bits=6):
    """(first, deltas, vq, scale, offset, bits) of a W_D compressed by the
    port, deltas uint8 or int16 as ``compress_model_params`` stores them."""
    from repro_torch.core import compression as comp
    c = comp.compress_wd(wd, nnz, value_bits=bits)
    ddt = torch.uint8 if c.achieved_delta_bits <= 8 else torch.int16
    return (c.deltas[0], c.deltas[1:].to(ddt), c.values_q, c.scale, c.offset,
            bits)


def small_linear_cases(torch, np, dev):
    """(kind, args) for the plain-vs-kernel check: "dmm" (args once with
    f32 and once with bf16 x), "dmm_tile_edge" and "dmm_small_edge" (bf16
    x), "smm" and "smm_edge"."""
    from repro_torch.core import compression as comp
    from repro_torch.core.factorized import pack_nibbles

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for M, K, N in DMM_SMALL:
        rng = np.random.default_rng(M + K + N)
        cws = comp.compress_ws(T((rng.normal(size=(K, N)) * 0.1).astype(
            np.float32)))
        x = T(rng.normal(size=(M, K)).astype(np.float32))
        for xx in (x, x.to(torch.bfloat16)):
            yield "dmm", (xx, pack_nibbles(cws.codes), cws.lut)
    for M, K, N in DMM_TILE_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = T(rng.integers(0, 16, size=(K, N)).astype(np.uint8))
        lut = T((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32))
        x = T(rng.standard_normal((M, K)).astype(np.float32))
        yield "dmm_tile_edge", (x.to(torch.bfloat16), pack_nibbles(codes),
                                lut)
    for M, K, N in DMM_SMALL_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = T(rng.integers(0, 16, size=(K, N)).astype(np.uint8))
        lut = T((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32))
        x = T(rng.standard_normal((M, K)).astype(np.float32))
        yield "dmm_small_edge", (x.to(torch.bfloat16), pack_nibbles(codes),
                                 lut)
    for M, r, N, nnz, kind in SMM_TILE_EDGES:
        rng = np.random.default_rng(M + r + N + nnz)
        st = [T(a) for a in smm_edge_streams(np, rng, r, N, nnz, kind)]
        y = T(rng.standard_normal((M, r)).astype(np.float32))
        yield "smm_edge", (y, *st, 1.3, -0.6, 6)
    for M, r, N, nnz, bits in SMM_SMALL:
        rng = np.random.default_rng(M + r + bits)
        wd = T(rng.normal(size=(r, N)).astype(np.float32))
        y = T(rng.normal(size=(M, r)).astype(np.float32))
        yield "smm", (y,) + wd_streams(torch, wd, nnz, bits)
    # indices past r, below 0 (negative int16 delta) and repeated
    first = T(np.array([0, 3, 15, 2, 5], np.int32))
    deltas = T(np.array([[1, 20, 0, -5, 0], [2, 1, 3, 4, 0]], np.int16))
    vq = T(np.random.default_rng(0).integers(0, 64, size=(3, 5)).astype(
        np.uint8))
    y = T(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    yield "smm", (y, first, deltas, vq, 1.5, -0.25, 6)


def linear_shapes(cfg):
    """{(d_in, d_out, r, nnz): [families]} of the factorized qwen2.5-32b
    linears at full width."""
    fc, d, hd = cfg.factorization, cfg.d_model, cfg.head_dim
    dims = {"attn_q": (d, cfg.n_heads * hd), "attn_k": (d, cfg.kv_heads * hd),
            "attn_v": (d, cfg.kv_heads * hd), "attn_o": (cfg.n_heads * hd, d),
            "ffn_up": (d, cfg.d_ff), "ffn_gate": (d, cfg.d_ff),
            "ffn_down": (cfg.d_ff, d)}
    out = {}
    for fam, (di, do) in dims.items():
        r = fc.rank_for(di, do)
        out.setdefault((di, do, r, fc.nnz_for(r)), []).append(fam)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# Tensor-core instructions each library's SASS must hold: the DMM body for
# bf16 x at M > 32 issues wgmma (HGMMA) and its small-M body mma.sync
# (HMMA), SMM's body for M > 32 wgmma, the mixed kernel's bf16 body
# mma.sync.
TENSOR_CORE_SASS = {"dmm": ("HGMMA", "HMMA"), "smm": ("HGMMA",),
                    "tda_mixed": ("HMMA",)}


def phase_build():
    """Build every kernel library, report ptxas's registers, shared memory
    and spills, and count the tensor-core instructions in the SASS of the
    libraries that must have them (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = {}
    for name, ops in TENSOR_CORE_SASS.items():
        dump = subprocess.run([str(cuobjdump), "-sass",
                               str(build._lib_path(name))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        sass[name] = {op: sum(
            any(tok.startswith(op) for tok in ln.split()[1:3])
            for ln in dump.splitlines() if ln.strip().startswith("/*"))
            for op in ops}
        for op in ops:
            if not sass[name][op]:
                fail(f"{name}: no {op} instruction in its SASS")
    line("build", seconds=round(time.perf_counter() - t0, 3),
         kernels=sorted(build.SOURCES), tensor_core_sass=sass,
         ptxas={n: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, v in log.items()})


def phase_kernels(torch, np, full_cfg, engine_kw):
    import torch.nn.functional as F
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_lut,
                                             decode_attention_reference,
                                             mixed_attention_lut,
                                             mixed_attention_reference)
    from repro_torch.models.layers import kv_dequantize, kv_quantize
    dev = torch.device("cuda")
    table = exp_lut_table(dev)

    def T(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dt is None or x.dtype == torch.int32 else x.to(dt)

    def opt_gather(t, bt):
        return None if t is None else gather(t, bt)

    # Plain versions: the ref.py oracle (LUT: the blockwise LUT recurrence,
    # one page a block for paged lanes) over gathered lanes. Each kernel is
    # compared on what it must compute (attended decode rows, live mixed
    # columns) and must write exact zeros elsewhere.
    def plain_decode(q, k, v, bounds, bt, ks=None, vs=None, lut=False):
        if lut:
            return decode_attention_lut(q, gather(k, bt), gather(v, bt),
                                        bounds, table, k.shape[1],
                                        opt_gather(ks, bt), opt_gather(vs, bt))
        return plain_contig(q, gather(k, bt), gather(v, bt), bounds,
                            opt_gather(ks, bt), opt_gather(vs, bt))

    def plain_contig(q, k, v, bounds, ks=None, vs=None, block_k=None):
        if block_k:
            return decode_attention_lut(q, k, v, bounds, table,
                                        min(block_k, k.shape[1]), ks, vs)
        hi, lo = bounds[:, 1:].long(), bounds[:, :1].long()
        return decode_attention_reference(q, k, v, hi, k_scale=ks,
                                          v_scale=vs, window=hi - lo)

    def plain_mixed(q, k, v, kr, vr, bounds, bt, ks=None, vs=None, lut=False,
                    block=None, **kw):
        lanes = (q, gather(k, bt), gather(v, bt), kr, vr, bounds[:, 0],
                 bounds[:, 1])
        sc = dict(k_scale=opt_gather(ks, bt), v_scale=opt_gather(vs, bt))
        if lut:  # LUT blocks: one page each (``block`` for a control)
            return mixed_attention_lut(*lanes, page_size=block or k.shape[1],
                                       table=table, **sc, **kw)
        return mixed_attention_reference(*lanes, **sc, **kw)

    def diff(got, plain, live):
        return (got - plain)[live].abs().max().item() if live.any() else 0.0

    def check(name, got, plain, live):
        e, lim = diff(got, plain, live), LUT_TOL if ".lut" in name else TOL
        err[name] = max(err[name], e)
        if not e <= lim or got[~live].any().item():
            fail(f"{name} vs plain: max abs diff {e} (limit {lim}); zeros "
                 f"outside the live part: {not got[~live].any().item()}")

    # Negative controls at full width: outputs a wrong kernel would give
    # (exact exp; LUT blocks of LUT_CONTROL_BLOCK positions) must miss the
    # LUT plain version by more than LUT_TOL on the same inputs.
    controls = {}

    def control(name, what, wrong, plain, live):
        e = diff(wrong, plain, live)
        controls.setdefault(name, {})[what] = e
        if not e > LUT_TOL:
            fail(f"{name}: the {what} control is within {LUT_TOL} of the "
                 f"LUT plain version ({e}): the check cannot tell them apart")

    # Rows no serve runs (the LUT and int8-mixed variants) take the launches
    # of their full-width check below.
    check_only = ("tda_decode_attention.lut", "tda_decode_attention.int8.lut",
                  "tda_paged_decode_attention.lut",
                  "tda_paged_decode_attention.int8.lut",
                  "tda_mixed_attention.lut", "tda_mixed_attention.int8",
                  "tda_mixed_attention.int8.lut")
    err = dict.fromkeys(
        ("tda_paged_decode_attention", "tda_mixed_attention",
         "tda_decode_attention", "tda_decode_attention.int8",
         "tda_paged_decode_attention.int8") + check_only, 0.0)
    tda.reset_launch_counts()
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for case in small_decode_cases(np):
            args = [T(a, dt) for a in case]
            live = args[3][:, 1] > args[3][:, 0]
            # fp pools, then int8 pools (codes of the same values) through
            # the same table; exact and LUT exp
            q, k, v, bounds, bt = args
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for suffix, pool in (("", (k, v)), (".int8", (kq, vq, ks, vs))):
                for lut in (False, True):
                    tab = table if lut else None
                    sc = pool[2:] or (None, None)
                    check("tda_paged_decode_attention" + suffix
                          + (".lut" if lut else ""),
                          tda.tda_paged_decode_attention(
                              q, *pool[:2], bounds, bt, *sc, tab),
                          plain_decode(q, *pool[:2], bounds, bt, *sc, lut),
                          live)
                    n_cases += 1
        for case in small_contig_cases(np):
            q, k, v, bounds = [T(a, dt) for a in case]
            live = bounds[:, 1] > bounds[:, 0]
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for suffix, lanes in (("", (k, v)), (".int8", (kq, vq, ks, vs))):
                sc = lanes[2:] or (None, None)
                check("tda_decode_attention" + suffix,
                      tda.tda_decode_attention(q, *lanes[:2], bounds, *sc),
                      plain_contig(q, *lanes[:2], bounds, *sc), live)
                for bk in (16, 128):  # LUT blocks: several, or one lane
                    check("tda_decode_attention" + suffix + ".lut",
                          tda.tda_decode_attention(q, *lanes[:2], bounds,
                                                   *sc, table, block_k=bk),
                          plain_contig(q, *lanes[:2], bounds, *sc, bk), live)
                n_cases += 3
        for case, kw in small_mixed_cases(np):
            q, k, v, kr, vr, bnd, bt = [T(a, dt) for a in case]
            live = torch.arange(q.shape[1], device=dev)[None] < bnd[:, 1:]
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for name, pool, lut in (
                    ("tda_mixed_attention", (k, v, None, None), False),
                    ("tda_mixed_attention.lut", (k, v, None, None), True),
                    ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
                    ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
                check(name, tda.tda_mixed_attention(
                    q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                    table if lut else None, **kw),
                    plain_mixed(q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                                lut, **kw), live)
                n_cases += 1
    torch.cuda.synchronize()
    line("kernels_small", cases=n_cases, max_abs_err=err)

    # Tile edges of the tensor-core mixed body (bf16 q), every variant.
    edge_err, n_edge = {}, 0
    for case, kw in mixed_tile_cases(np):
        q, k, v, kr, vr, bnd, bt = [T(a, torch.bfloat16) for a in case]
        live = torch.arange(q.shape[1], device=dev)[None] < bnd[:, 1:]
        kq, ks = kv_quantize(T(case[1]))
        vq, vs = kv_quantize(T(case[2]))
        for name, pool, lut in (
                ("tda_mixed_attention", (k, v, None, None), False),
                ("tda_mixed_attention.lut", (k, v, None, None), True),
                ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
                ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
            got = tda.tda_mixed_attention(q, *pool[:2], kr, vr, bnd, bt,
                                          *pool[2:], table if lut else None,
                                          **kw)
            plain = plain_mixed(q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                                lut, **kw)
            edge_err[name] = max(edge_err.get(name, 0.0),
                                 diff(got, plain, live))
            check(name, got, plain, live)
            n_edge += 1
    torch.cuda.synchronize()
    line("kernels_tile_edges", cases=n_edge, max_abs_err=edge_err,
         limits={"exact": TOL, "lut": LUT_TOL})

    # Full-width shapes of phase 4, bf16 as the main path runs them.
    bf = torch.bfloat16
    cache_len = engine_kw["max_len"] * 2 + engine_kw["max_new_tokens"]
    dec, mix = full_cases(np, full_cfg, engine_kw["num_slots"],
                          cache_len, 128, engine_kw["max_len"])
    Hq, Hkv, D = full_cfg.n_heads, full_cfg.kv_heads, full_cfg.head_dim
    rows = []

    def checked(name, fn, plain, live):
        """Check one full-width call; returns the launches it made."""
        n0 = tda.VARIANT_LAUNCHES[name]
        got = fn()
        n = tda.VARIANT_LAUNCHES[name] - n0
        check(name, got, plain(), live)
        return n

    def add_row(name, src, repl, fn, plain, library, lib_label, nbytes,
                flops, shape, launches, plain_reps=20, device=False):
        """Time a checked kernel and its yardsticks (``device``: also the
        kernel's and the library call's device time alone); rows no serve
        runs take the launches of their full-width check."""
        bms, by = bound(nbytes, flops, 2)
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": repl}
        if name in check_only:
            row.update(launches=launches, launches_from="check")
        row.update({
            "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain, plain_reps),
            "library_ms": time_ms(torch, library), "library": lib_label,
            "bound_ms": bms, "bound_by": by, "shape": shape})
        if device:
            row.update(device_ms=device_ms(torch, fn),
                       library_device_ms=device_ms(torch, library))
        rows.append(row)

    # --- decode: every slot attends [0, length); all rows live. Paged
    # (128-token pages) and contiguous lanes of cache_len (544) positions,
    # the engine's layouts; bf16, then int8 codes of the same values with
    # q in bf16; exact exp, then the LUT exp (contiguous: the reference's
    # block_k 128).
    q, k, v, bounds, bt = [T(a, bf) for a in dec]
    lens = dec[3][:, 1] - dec[3][:, 0]
    tokens = int(lens.sum())
    B = int(q.shape[0])
    live = bounds[:, 1] > bounds[:, 0]
    qo_bytes = q.numel() * 2 + B * Hq * D * 4 + bounds.numel() * 4
    kl = gather(k, bt)[:, :cache_len].contiguous()
    vl = gather(v, bt)[:, :cache_len].contiguous()
    pos = torch.arange(cache_len, device=dev)
    lmask = ((pos[None] >= bounds[:, :1]) & (pos[None] < bounds[:, 1:]))[
        :, None, None, :]
    kq, ks = kv_quantize(kl)
    vq, vs = kv_quantize(vl)
    kpq, kps = kv_quantize(k)
    vpq, vps = kv_quantize(v)
    # SDPA yardsticks (exact exp) over bf16 lanes; the int8 ones over lanes
    # dequantized beforehand (untimed)
    sdpa_in = {"fp": (kl, vl), "int8": (kv_dequantize(kq, ks, bf),
                                        kv_dequantize(vq, vs, bf)),
               "paged_int8": (kv_dequantize(gather(kpq, bt), gather(kps, bt),
                                            bf)[:, :cache_len],
                              kv_dequantize(gather(vpq, bt), gather(vps, bt),
                                            bf)[:, :cache_len])}

    def sdpa(which):
        kk, vv = (t.permute(0, 2, 1, 3) for t in sdpa_in[which])
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=lmask, enable_gqa=True)

    paged = {"page_size": int(k.shape[1]), "pool_pages": int(k.shape[0])}
    fp_b, q8_b = Hkv * D * 2 * 2, Hkv * (D + 4) * 2
    # contiguous lanes of each variant's values (by its SDPA key), for the
    # block-partition control
    contig = {"fp": (kl, vl), "int8": (kq, vq, ks, vs),
              "paged_int8": (kq, vq, ks, vs)}
    variants = (  # name, lanes (k, v[, ks, vs]), paged, LUT, SDPA
        ("tda_paged_decode_attention", (k, v), True, False, "fp"),
        ("tda_decode_attention", (kl, vl), False, False, "fp"),
        ("tda_decode_attention.int8", (kq, vq, ks, vs), False, False, "int8"),
        ("tda_paged_decode_attention.int8", (kpq, vpq, kps, vps), True, False,
         "paged_int8"),
        ("tda_decode_attention.lut", (kl, vl), False, True, "fp"),
        ("tda_decode_attention.int8.lut", (kq, vq, ks, vs), False, True,
         "int8"),
        ("tda_paged_decode_attention.lut", (k, v), True, True, "fp"),
        ("tda_paged_decode_attention.int8.lut", (kpq, vpq, kps, vps), True,
         True, "paged_int8"))
    for name, lanes, is_paged, lut, lib in variants:
        sc = lanes[2:] or (None, None)
        tab = table if lut else None
        if is_paged:
            fn = (lambda lanes=lanes, sc=sc, tab=tab:
                  tda.tda_paged_decode_attention(q, *lanes[:2], bounds, bt,
                                                 *sc, tab))
            plain = (lambda lanes=lanes, sc=sc, lut=lut: plain_decode(
                q, *lanes[:2], bounds, bt, *sc, lut))
        else:
            fn = (lambda lanes=lanes, sc=sc, tab=tab:
                  tda.tda_decode_attention(q, *lanes[:2], bounds, *sc, tab,
                                           block_k=128))
            plain = (lambda lanes=lanes, sc=sc, lut=lut: plain_contig(
                q, *lanes[:2], bounds, *sc, 128 if lut else None))
        launches = checked(name, fn, plain, live)
        if lut:
            want = plain()
            exact = (tda.tda_paged_decode_attention(q, *lanes[:2], bounds, bt,
                                                    *sc) if is_paged else
                     tda.tda_decode_attention(q, *lanes[:2], bounds, *sc))
            control(name, "exact_exp", exact, want, live)
            cl = contig[lib]
            control(name, f"block_{LUT_CONTROL_BLOCK}",
                    tda.tda_decode_attention(
                        q, *cl[:2], bounds, *(cl[2:] or (None, None)),
                        table, block_k=LUT_CONTROL_BLOCK), want, live)
        quant = len(lanes) == 4
        dtype = ("int8 k/v + f32 scales, bf16 q" if quant else "bfloat16") \
            + (", LUT exp" if lut else "")
        add_row(name, "tda_paged_decode.cu" if is_paged else "tda_decode.cu",
                "src/repro/kernels/tda/tda.py:" + ("220" if is_paged
                                                   else "168"),
                fn, plain, sdpa(lib),
                "SDPA over " + ("bf16 lanes" if lib == "fp" else
                                "lanes dequantized to bf16 beforehand "
                                "(untimed)") + (" (exact exp)" if lut else ""),
                tokens * (q8_b if quant else fp_b) + qo_bytes
                + (bt.numel() * 4 if is_paged else 0),
                4 * tokens * Hq * D,
                {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D,
                 "lane": paged if is_paged else int(cache_len),
                 "tokens_attended": tokens, "dtype": dtype}, launches,
                device=True)
    del kl, vl, kq, vq, kpq, vpq, sdpa_in, contig

    # --- mixed step: the bf16 pool, then int8 codes of the same values
    # (the chunk stays bf16); exact and LUT exp.
    q, k, v, kr, vr, bnd, bt = [T(a, bf) for a in mix]
    ring = cache_len
    S = q.shape[1]
    cols = torch.arange(S, device=dev)
    mlive = cols[None] < bnd[:, 1:]
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    # The bound counts the live work only: a row's cache keys are read only
    # when it has a live column (n_new > 0), and only live columns' queries
    # and outputs count; an int8 pool moves 1-byte codes plus a 4-byte
    # scale per head row. The kernel's zero-writes of unread columns are its
    # own cost, not the function's.
    ci, nn = mix[5][:, 0].astype(np.int64), mix[5][:, 1].astype(np.int64)
    cache_keys = np.where(nn > 0, np.minimum(ci, ring), 0)
    keys = int((nn * cache_keys + nn * (nn + 1) // 2).sum())  # per live column
    live_cols = int(nn.sum())
    r = torch.arange(bt.shape[1] * k.shape[1], device=dev)
    cit, nnt = bnd[:, :1].long(), bnd[:, 1:].long()
    cmask = (r[None] < torch.clamp(cit, max=ring))[:, None, :].expand(-1, S,
                                                                      -1)
    rmask = (cols[None, :, None] >= cols[None, None, :]) & \
        (cols[None, None, :] < nnt[:, :, None])
    fmask = torch.cat([cmask, rmask], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    sq = q.permute(0, 2, 1, 3)
    for name, pool, lut in (
            ("tda_mixed_attention", (k, v, None, None), False),
            ("tda_mixed_attention.lut", (k, v, None, None), True),
            ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
            ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
        tab = table if lut else None
        fn = (lambda pool=pool, tab=tab: tda.tda_mixed_attention(
            q, *pool[:2], kr, vr, bnd, bt, *pool[2:], tab, ring=ring))
        plain = (lambda pool=pool, lut=lut: plain_mixed(
            q, *pool[:2], kr, vr, bnd, bt, *pool[2:], lut, ring=ring))
        launches = checked(name, fn, plain, mlive)
        if lut:
            want = plain()
            control(name, "exact_exp", tda.tda_mixed_attention(
                q, *pool[:2], kr, vr, bnd, bt, *pool[2:], ring=ring), want,
                mlive)
            control(name, f"block_{LUT_CONTROL_BLOCK}", plain_mixed(
                q, *pool[:2], kr, vr, bnd, bt, *pool[2:], True,
                LUT_CONTROL_BLOCK, ring=ring), want, mlive)
        quant = pool[2] is not None
        kl, vl = (gather(t, bt) if not quant else
                  kv_dequantize(gather(t, bt), gather(s, bt), bf)
                  for t, s in ((pool[0], pool[2]), (pool[1], pool[3])))
        keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
        vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
        nbytes = int(cache_keys.sum()) * (q8_b if quant else fp_b) \
            + live_cols * fp_b + live_cols * Hq * D * (2 + 4) \
            + bnd.numel() * 4 + bt.numel() * 4
        add_row(name, "tda_mixed.cu", "src/repro/kernels/tda/tda.py:391", fn,
                plain, lambda ka=keys_all, va=vals_all:
                F.scaled_dot_product_attention(
                    sq, ka, va, attn_mask=fmask[:, None], enable_gqa=True),
                "SDPA over " + ("lanes dequantized to bf16 beforehand "
                                "(untimed)" if quant else "bf16 lanes")
                + " and the chunk" + (" (exact exp)" if lut else ""),
                nbytes, 4 * keys * Hq * D,
                {"B": B, "S": int(S), "Hq": Hq, "Hkv": Hkv, "D": D,
                 "rows_ci_nnew": mix[5].tolist(), "live_columns": live_cols,
                 "bound_bytes": nbytes, "live_query_key_pairs_per_head": keys,
                 "dtype": ("int8 pool + f32 scales, bf16 q and chunk"
                           if quant else "bfloat16")
                 + (", LUT exp" if lut else "")}, launches, plain_reps=5)
        del kl, vl, keys_all, vals_all
    for row in rows:
        row["max_abs_err"] = err[row["name"]]
    torch.cuda.synchronize()
    line("kernels_full", controls=controls, limits={"exact": TOL,
                                                    "lut": LUT_TOL},
         **{r["name"]: {k: r[k] for k in (
             "ms", "device_ms", "plain_ms", "library_ms",
             "library_device_ms", "library", "bound_ms", "bound_by",
             "max_abs_err", "shape") if k in r} for r in rows})
    return rows


# AFU shapes: the kernel table's softmax (256, 512); decode scores of 8
# slots x 40 heads over a 544-token lane; the LM head's rows over 152 064
# entries (re-read from device memory); the reference test's ragged edge.
# LayerNorm: the reference test's (40, 64), a decode step's 8 and a mixed
# step's 2048 tokens of d_model 5120, and a ragged edge.
SOFTMAX_SHAPES = [(256, 512), (320, 544), (8, 152064), (7, 999), (33, 50)]
LN_SHAPES = [(40, 64), (8, 5120), (2048, 5120), (7, 999)]
LN_ROW = (2048, 5120)  # the kernels-line row's shape


def phase_afu(torch):
    """The AFU kernels against their plain versions at SOFTMAX_SHAPES and
    LN_SHAPES, f32 and bf16 inputs (softmax within SOFTMAX_RTOL per
    element, LayerNorm within LN_TOL), then timed at each shape (f32
    softmax, bf16 LayerNorm as the serve's hidden states). Negative
    control: the exact-exp softmax (``torch.softmax``) must miss the LUT
    plain version by more than SOFTMAX_RTOL at every shape. Returns the two
    rows: softmax at the kernel table's shape, its launches from the
    ``kernel_table`` phase; LayerNorm at LN_ROW, its launches from the
    checks at that shape (f32 and bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import (exp_lut_table,
                                             layernorm_residual_reference,
                                             softmax_lut_reference)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4)
    table = exp_lut_table(dev)
    err = {"softmax_lut": 0.0, "layernorm_residual": 0.0}
    rel = {"softmax_lut": 0.0, "layernorm_residual": 0.0}  # vs the limits
    controls = {}

    def check(name, got, plain):
        e = (got - plain).abs().max().item()
        if name == "softmax_lut":
            r, lim = rel_err(got, plain), SOFTMAX_RTOL
        else:
            r, lim = e / max(1.0, plain.abs().max().item()), LN_TOL
        err[name], rel[name] = max(err[name], e), max(rel[name], r)
        if not r <= lim:
            fail(f"{name} vs plain: {r} (limit {lim}; max abs diff {e}) at "
                 f"{tuple(got.shape)}")

    afu.reset_launch_counts()
    inputs = {}
    for R, C in SOFTMAX_SHAPES:
        x = torch.randn(R, C, generator=g, device=dev) * 4
        for xx in (x, x.to(torch.bfloat16)):
            check("softmax_lut", afu.softmax_lut(xx, table),
                  softmax_lut_reference(xx, table))
        c = rel_err(torch.softmax(x, -1), softmax_lut_reference(x, table))
        controls[f"exact_exp {R}x{C}"] = c
        if not c > SOFTMAX_RTOL:
            fail(f"softmax_lut: the exact-exp control is within "
                 f"{SOFTMAX_RTOL} of the LUT plain version ({c}) at {R}x{C}")
        inputs["softmax", R, C] = x
    for R, C in LN_SHAPES:
        x, res = (torch.randn(R, C, generator=g, device=dev) for _ in "xr")
        sc, bi = (torch.randn(C, generator=g, device=dev) for _ in "sb")
        n0 = afu.LAUNCHES["layernorm_residual"]
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), res.to(dt), sc, bi)
            check("layernorm_residual", afu.layernorm_residual(*args),
                  layernorm_residual_reference(*args))
        if (R, C) == LN_ROW:
            ln_launches = afu.LAUNCHES["layernorm_residual"] - n0
        inputs["ln", R, C] = (x.to(torch.bfloat16), res.to(torch.bfloat16),
                              sc, bi)
    torch.cuda.synchronize()
    times = {}
    for (kind, R, C), a in inputs.items():
        if kind == "softmax":
            nbytes, ops = R * C * (4 + 4) + 256, 14 * R * C
            fn = (lambda x=a: afu.softmax_lut(x, table))
            plain = (lambda x=a: softmax_lut_reference(x, table))
            lib = (lambda x=a: torch.softmax(x.float(), -1))
        else:
            nbytes, ops = R * C * (2 * 2 + 4) + 8 * C, 8 * R * C
            fn = (lambda a=a: afu.layernorm_residual(*a))
            plain = (lambda a=a: layernorm_residual_reference(*a))
            lib = (lambda a=a: F.layer_norm(
                a[0].float() + a[1].float(), (a[0].shape[1],), a[2], a[3],
                1e-6))
        bms, by = bound(nbytes, ops, 4)
        times[f"{kind} {R}x{C}"] = {
            "ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain, 5),
            "library_ms": time_ms(torch, lib), "bound_ms": bms,
            "bound_by": by,
            "dtype": "float32" if kind == "softmax" else "bfloat16"}
    line("afu", seconds=round(time.perf_counter() - t0, 3),
         max_abs_err=err, err_vs_limit=rel,
         limits={"softmax_rtol": SOFTMAX_RTOL, "layernorm": LN_TOL},
         controls=controls, **times)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out = []
    for name, repl, key, lib in (
            ("softmax_lut", "src/repro/kernels/afu/afu.py:35",
             "softmax 256x512", "torch.softmax (exact exp: the same "
             "traffic, not the same function)"),
            ("layernorm_residual", "src/repro/kernels/afu/afu.py:61",
             "ln %dx%d" % LN_ROW, "add + F.layer_norm, timed together")):
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/afu.cu",
                    "replaces": repl, "max_abs_err": err[name],
                    **{k: times[key][k] for k in keys}, "library": lib,
                    "shape": key.split()[1],
                    "other_shapes": {k: {kk: v[kk] for kk in keys}
                                     for k, v in times.items()
                                     if k.startswith(key.split()[0])
                                     and k != key}})
    out[1].update(launches=ln_launches, launches_from="check")
    return out


def phase_kernel_table(torch):
    """The slice's entry point: the launcher's ``kernels`` and
    ``decode_attn`` tables in-process on the card, every launch counter
    set to 0 just before and read just after. Every row must carry the
    reference's name and a finite time, the LUT softmax's error against
    the exact one must stay below 5e-3 (the reference test's bound), and
    each kernel's output in the tables is held against its plain version
    on the same inputs (``Table.outputs``): DMM and SMM within TOL x
    max(1, max |plain|) as in ``linear_kernels``, the LUT softmax within
    SOFTMAX_RTOL per element, the int8 decode kernel within TOL of the
    dense oracle. Returns the launches."""
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.launch import kernel_table
    t0 = time.perf_counter()
    mods = (afu, dmm, smm, tda)
    for mod in mods:
        mod.reset_launch_counts()
    results = kernel_table.run(kernel_table.TABLES, torch.device("cuda"))
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    rows = [r for t in results.values() for r in t.rows]
    want = ["kernels/dmm_lut_matmul", "kernels/smm_compressed_matmul",
            "kernels/afu_softmax_lut", "decode_attn/fused",
            "decode_attn/dense", "decode_attn/blocks"]
    errs = {}
    for name, (got, plain) in (kv for t in results.values()
                               for kv in t.outputs.items()):
        e = (got - plain).abs().max().item()
        if name == "kernels/afu_softmax_lut":
            e, lim = rel_err(got, plain), SOFTMAX_RTOL
        elif name == "decode_attn/fused":
            lim = TOL
        else:
            lim = TOL * max(1.0, plain.abs().max().item())
        errs[name] = e
        if not e <= lim:
            fail(f"kernel table {name} vs plain: {e} (limit {lim})")
    if sorted(errs) != sorted(want[:4]):
        fail(f"kernel table: outputs of {sorted(errs)}, want {want[:4]}")
    if [r[0] for r in rows] != want:
        fail(f"kernel table rows {[r[0] for r in rows]} != {want}")
    if not all(math.isfinite(us) for _, us, _ in rows):
        fail(f"kernel table: a non-finite time in {rows}")
    lut_err = results["kernels"].metrics["max_err_vs_exact"]
    if not lut_err < 5e-3:
        fail(f"kernels/afu_softmax_lut: max_err_vs_exact {lut_err} >= 5e-3")
    for name in ("dmm_matmul", "smm_matmul", "softmax_lut",
                 "tda_decode_attention"):
        if not launches[name]:
            fail(f"kernel table: {name} was not launched ({launches})")
    line("kernel_table", seconds=round(time.perf_counter() - t0, 3),
         csv=[f"{n},{us:.1f},{d}" for n, us, d in rows],
         max_err_vs_exact=lut_err, err_vs_plain=errs,
         decode_attn=results["decode_attn"].metrics, launches=launches)
    return launches


# The linear rows' yardsticks (``library_ms``): the same function as one
# PyTorch call on the densified matrix in f32; ``library_bf16_ms`` the bf16
# product on the bf16-rounded matrix (SMM: of bf16-rounded y), a
# single-pass, lower-precision product.
LINEAR_LIBRARY = {
    "dmm": "torch.matmul, f32 x on the f32 densified W (TF32 off); "
           "library_bf16_ms: bf16 x on the bf16-rounded W, a single-pass, "
           "lower-precision product",
    "smm": "torch.matmul on the f32 densified W_D (TF32 off); "
           "library_bf16_ms: bf16 y on the bf16-rounded W_D, a single-pass, "
           "lower-precision product"}


def phase_linear_kernels(torch, np, ccfg):
    """DMM and SMM against their plain versions: the CPU tests' edge cases
    and the redesigned bodies' edges (each edge launched twice, which must
    give the same bits, and counted against the body its shapes select),
    then every family's full-width shapes at M = 8 and 2048, timed by
    events (``ms``) and by the kernels' device time alone (``device_ms``)."""
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.dmm.ops import lut_matmul
    from repro_torch.kernels.dmm.ref import unpack_nibbles
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.smm.ops import compressed_matmul
    from repro_torch.kernels.smm.ref import densify
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    err = {"dmm_matmul": 0.0, "smm_matmul": 0.0}
    smm_op = ("smm_matmul", lambda *a, **kw: compressed_matmul(
        *a[:6], value_bits=a[6], **kw))
    ops = {"dmm": ("dmm_matmul", lut_matmul),
           "dmm_tile_edge": ("dmm_matmul", lut_matmul),
           "dmm_small_edge": ("dmm_matmul", lut_matmul),
           "smm": smm_op, "smm_edge": smm_op}
    bodies = {"dmm_matmul": dmm.BODY_LAUNCHES, "smm_matmul": smm.BODY_LAUNCHES}

    def check(kind, args):
        name, op = ops[kind]
        before = dict(bodies[name])
        got = op(*args)
        if kind.endswith("edge"):
            again = op(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{name}: a second launch on the same inputs gave other "
                     f"bits at {[tuple(a.shape) for a in args[:2]]}")
        ran = [k for k in before if bodies[name][k] != before[k]]
        plain = op(*args, use_kernel=False)
        torch.cuda.synchronize()
        e = (got - plain).abs().max().item() if got.numel() else 0.0
        lim = TOL * max(1.0, plain.abs().max().item() if got.numel() else 0)
        err[name] = max(err[name], e)
        if kind.endswith("edge"):
            key = "x".join(str(d) for d in (*args[0].shape, args[1].shape[-1]))
            if kind == "smm_edge":
                key += f"/nnz{args[3].shape[0]}/{args[2].dtype}".replace(
                    "torch.", "")
            edges.setdefault(kind, {})[key] = {
                "max_abs_err": e, "limit": lim, "body": ran}
        if not e <= lim:
            fail(f"{name} vs plain: max abs diff {e} (limit {lim}) at "
                 f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}")
        return {"max_abs_err": e, "limit": lim, "body": ran}

    n_cases, edges = 0, {}
    for kind, args in small_linear_cases(torch, np, dev):
        check(kind, args)
        n_cases += 1
    line("linear_kernels_small", cases=n_cases, max_abs_err=dict(err),
         edges=edges)

    g = torch.Generator(device=dev).manual_seed(3)
    shapes, rows = [], {}
    for (d_in, d_out, r, nnz), fams in linear_shapes(ccfg).items():
        codes = torch.randint(0, 256, ((d_in + 1) // 2, r), generator=g,
                              device=dev, dtype=torch.uint8)
        lut = torch.sort(torch.randn(16, generator=g, device=dev)).values \
            / d_in ** 0.5
        ws_f32 = lut[unpack_nibbles(codes).long()][:d_in]
        ws_bf16 = ws_f32.to(torch.bfloat16)
        st = wd_streams(torch, torch.randn(r, d_out, generator=g,
                                           device=dev), nnz)
        # the layer's scalars as the serve passes them: 0-d device tensors
        st = st[:3] + tuple(torch.as_tensor(v, dtype=dt, device=dev).reshape(
            ()) for v, dt in zip(st[3:], (torch.float32, torch.float32,
                                          torch.int32)))
        wd_dense = densify(*st[:5], r, st[5])
        wd_bf16 = wd_dense.to(torch.bfloat16)
        rec = {"families": fams, "d_in": d_in, "d_out": d_out, "r": r,
               "nnz": nnz, "delta_dtype": str(st[1].dtype).split(".")[1]}
        for M in (8, 2048):
            x = torch.randn(M, d_in, generator=g, device=dev).to(
                torch.bfloat16)
            x32 = x.float()  # the f32 yardstick's input, made untimed
            y = torch.randn(M, r, generator=g, device=dev)
            y16 = y.to(torch.bfloat16)
            checked = {"dmm": check("dmm", (x, codes, lut)),
                       "smm": check("smm", (y,) + st)}
            dmm_b, dmm_by = bound(x.numel() * 2 + codes.numel() + 64
                                  + M * r * 4, 2 * M * d_in * r, 2)
            smm_b, smm_by = bound(
                y.numel() * 4 + d_out * 4
                + st[1].numel() * st[1].element_size() + st[2].numel()
                + M * d_out * 4, 2 * M * nnz * d_out, 4)
            calls = {
                "dmm": (lambda: lut_matmul(x, codes, lut),
                        lambda: lut_matmul(x, codes, lut, use_kernel=False),
                        lambda: torch.matmul(x32, ws_f32),
                        lambda: torch.matmul(x, ws_bf16), dmm_b, dmm_by),
                "smm": (lambda: compressed_matmul(
                            y, *st[:5], value_bits=st[5]),
                        lambda: compressed_matmul(
                            y, *st[:5], value_bits=st[5], use_kernel=False),
                        lambda: torch.matmul(y, wd_dense),
                        lambda: torch.matmul(y16, wd_bf16), smm_b, smm_by)}
            for kern, (fn, plain, lib, lib16, b, by) in calls.items():
                rec[f"{kern}_M{M}"] = {
                    "ms": time_ms(torch, fn, 10),
                    "device_ms": device_ms(torch, fn, 10),
                    "plain_ms": time_ms(torch, plain, 5),
                    "library_ms": time_ms(torch, lib, 10),
                    "library_device_ms": device_ms(torch, lib, 10),
                    "library_bf16_ms": time_ms(torch, lib16, 10),
                    "bound_ms": b, "bound_by": by, **checked[kern]}
        shapes.append(rec)
        for kern, fam in (("dmm", "ffn_down"), ("smm", "ffn_up")):
            if fam in fams:
                rows[kern] = rec
        del codes, ws_f32, ws_bf16, wd_dense, wd_bf16, st, x32, y16
    torch.cuda.synchronize()
    line("linear_kernels_full", seconds=round(time.perf_counter() - t0, 3),
         max_abs_err=dict(err), shapes=shapes)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "library_bf16_ms", "bound_ms", "bound_by")
    out = []
    for kern, name, src, repl in (
            ("dmm", "dmm_matmul", "dmm.cu",
             "src/repro/kernels/dmm/dmm.py:51"),
            ("smm", "smm_matmul", "smm.cu",
             "src/repro/kernels/smm/smm.py:63")):
        rec = rows[kern]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": repl, "max_abs_err": err[name],
               **{k: rec[f"{kern}_M2048"][k] for k in keys},
               "M8": {k: rec[f"{kern}_M8"][k] for k in keys},
               "library": LINEAR_LIBRARY[kern],
               "shape": {k: rec[k] for k in ("families", "d_in", "d_out", "r",
                                             "nnz")} | {"M": 2048}}
        out.append(row)
    return out


def decompressed(torch, cparams, params):
    """The compressed tree with every stream group replaced by its dense
    ``wd`` (``decompress_wd_leaf`` per layer) and every dictionary by its
    dense W_S (``decompress_ws_entry``): served through the plain
    factorized ``(x @ ws) @ wd``."""
    from repro_torch.core.factorized import (decompress_wd_leaf,
                                             decompress_ws_entry)

    def walk(c, p):
        if isinstance(c, dict) and "wd_vq" in c:
            r = p["wd"].shape[-2]
            out = {k: v for k, v in c.items() if not k.startswith("wd_")}
            layers = [decompress_wd_leaf({k: v[i] for k, v in c.items()}, r)
                      for i in range(c["wd_vq"].shape[0])]
            out["wd"] = torch.stack(layers)
            return out
        if isinstance(c, dict):
            return {k: walk(v, p[k]) for k, v in c.items()}
        return c

    tree = {k: walk(v, params[k]) for k, v in cparams.items() if k != "dicts"}
    tree["dicts"] = {f: decompress_ws_entry(e, params["dicts"][f].shape[0])
                     for f, e in cparams["dicts"].items()}
    return tree


def phase_tokens(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import (FactorizationConfig,
                                             project_wd_leaves)
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    import numpy as np
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    rng = np.random.default_rng(1)
    lengths, budgets, ticks = [5, 25, 12, 18], [6, 5, 4, 6], [1, 1, 3, 6]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]

    def run(model, params, budget, **kw):
        eng = Engine(model, params, config=EngineConfig(
            max_len=16, max_new_tokens=8, num_slots=3, max_prompt_len=40,
            prefix_share=False, prefill_budget=budget, **kw))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        done = eng.run(arrivals=list(zip(ticks, reqs)))
        if sorted(r.rid for r in done) != [0, 1, 2, 3] or \
                any(r.status != "ok" for r in done):
            fail("a smoke run did not finish all requests ok")
        return {r.rid: list(r.output) for r in done}, eng.decode_stats

    model = Model(cfg)
    params = model.init(seed=0)
    checked = []
    for budget in (4, 16, None):
        outs = {}
        for mode in ("tda", "dense"):
            tda.reset_launch_counts()
            outs[mode], _ = run(model, params, budget, decode_attn=mode)
            if mode == "tda" and not (
                    tda.LAUNCHES["tda_paged_decode_attention"]
                    and tda.LAUNCHES["tda_mixed_attention"]):
                fail(f"tda engine did not launch both kernels: {tda.LAUNCHES}")
        if outs["tda"] != outs["dense"]:
            fail(f"tokens differ, kernels vs plain path (budget {budget}): "
                 f"{outs}")
        checked.append(budget)
    n_tok = sum(len(v) for v in outs["tda"].values())

    # Phase-serialized engine: contiguous and paged lanes, on the kernels
    # and on the plain path, fp (against the mixed engine's tokens), then
    # int8 kv_quant lanes (against each other and the plain path).
    kernel_of = {False: "tda_decode_attention",
                 True: "tda_paged_decode_attention"}
    for quant in (False, True):
        m = Model(dataclasses.replace(cfg, kv_quant=True)) if quant \
            else model
        want = None if quant else outs["tda"]
        for paged in (False, True):
            for mode in ("tda", "dense"):
                tda.reset_launch_counts()
                got_s, _ = run(m, params, None, decode_attn=mode, paged=paged,
                               mixed=False)
                if mode == "tda" and (not tda.LAUNCHES[kernel_of[paged]]
                                      or tda.LAUNCHES["tda_mixed_attention"]
                                      or tda.LAUNCHES[kernel_of[not paged]]):
                    fail(f"serialized engine (paged={paged}, kv_quant="
                         f"{quant}) launched {tda.LAUNCHES}")
                want = got_s if want is None else want
                if got_s != want:
                    fail(f"serialized tokens differ (paged={paged}, "
                         f"kv_quant={quant}, {mode}): {got_s} vs {want}")
    ser_tok = sum(len(v) for v in want.values())

    # Compressed: the DMM/SMM kernels vs the same factors decompressed.
    fcfg = FactorizationConfig(enabled=True, min_dim=32, rank=32, nnz=8)
    fmodel = Model(get_config("qwen2.5-32b", "smoke", dtype="float32",
                              factorization=fcfg))
    fparams = project_wd_leaves(fmodel.init(seed=0), fcfg)
    mc, cparams, _ = fmodel.compress_params(fparams)
    recon = decompressed(torch, cparams, fparams)
    for budget in (16, None):
        dmm.reset_launch_counts()
        smm.reset_launch_counts()
        got, st = run(mc, cparams, budget)
        n_lin = 7 * cfg.n_layers * st["steps"]
        if not dmm.LAUNCHES["dmm_matmul"] == smm.LAUNCHES["smm_matmul"] \
                == n_lin:
            fail(f"compressed smoke: dmm/smm launches {dmm.LAUNCHES} "
                 f"{smm.LAUNCHES} != {n_lin}")
        want, _ = run(fmodel, recon, budget)
        if got != want:
            fail(f"compressed tokens differ, DMM/SMM kernels vs decompressed "
                 f"factors (budget {budget}): {got} vs {want}")
    line("tokens", seconds=round(time.perf_counter() - t0, 3),
         float32_smoke_identical=True, prefill_budgets=checked, tokens=n_tok,
         serialized_identical={
             "contiguous_and_paged_vs_mixed_and_plain": True,
             "int8_contiguous_vs_paged_vs_plain": True},
         serialized_int8_tokens=ser_tok,
         compressed_identical=True, compressed_prefill_budgets=[16, None],
         compressed_tokens=sum(len(v) for v in got.values()))


def serve_run(torch, np, model, params, engine_kw, **cfg_kw):
    """Serve ``profile_serve.workload`` through ``Engine.run`` after one
    warm-up request, with every launch counter set to 0 just before the
    run and read just after. Checks every request ends ``ok`` with
    ``max_new_tokens`` valid tokens and each TDA kernel launches once per
    layer per step of its kind: the mixed engine's paged decode and mixed
    kernels, the serialized engine's contiguous or paged decode kernel
    (every one of its steps is a decode step), and no other. Returns
    (summary dict, launches)."""
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.launch.profile_serve import workload
    from repro_torch.serve import Engine, EngineConfig
    cfg = model.cfg
    t0 = time.perf_counter()
    eng = Engine(model, params, config=EngineConfig(prefix_share=False,
                                                    **cfg_kw, **engine_kw))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm, up_front, arrivals, lengths = workload(
        cfg.vocab_size, engine_kw["max_new_tokens"])
    eng.submit(warm)  # library initialisation, first launches
    eng.run()
    for r in up_front:
        eng.submit(r)
    n_sweeps0 = len(eng.stats)
    torch.cuda.synchronize()
    for mod in (tda, dmm, smm):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**tda.LAUNCHES, **dmm.LAUNCHES, **smm.LAUNCHES,
                **dmm.BODY_LAUNCHES, **smm.BODY_LAUNCHES}
    st = eng.decode_stats
    if sorted(r.rid for r in done) != list(range(16)):
        fail("not every request came back")
    bad = [(r.rid, r.status, r.status_reason) for r in done
           if r.status != "ok"]
    if bad:
        fail(f"requests not ok: {bad}")
    if any(len(r.output) != engine_kw["max_new_tokens"]
           or not all(0 <= t < cfg.vocab_size for t in r.output)
           for r in done):
        fail("a request's output has the wrong length or an invalid token")
    L = cfg.n_layers
    n_dec = st["steps"] - st["mixed_steps"]
    want = {"tda_decode_attention": 0, "tda_paged_decode_attention": 0,
            "tda_mixed_attention": L * st["mixed_steps"]}
    want["tda_paged_decode_attention" if eng.paged
         else "tda_decode_attention"] = L * n_dec
    n_used = sum(1 for n in want.values() if n)
    if any(launches[k] != n for k, n in want.items()) or \
            n_used != (2 if eng.mixed else 1):
        fail(f"launch counts {launches}, want {want}: {L} layers x "
             f"({n_dec} decode, {st['mixed_steps']} mixed) steps")
    ttft = sorted(v["wall_s"] for v in st["ttft"].values())
    toks = sum(len(r.output) for r in done)
    sweeps = eng.stats[n_sweeps0:]

    def median(v):
        return float(np.median(v)) if v else None

    summary = dict(
        model=cfg.name, weight_format=cfg.weight_format,
        engine="mixed" if eng.mixed else "serialized",
        lanes="paged" if eng.paged else "contiguous",
        kv="int8" if cfg.kv_quant else str(cfg.compute_dtype).split(".")[1],
        d_model=cfg.d_model, n_layers=L,
        reduced={"n_layers": "64 -> 8 (depth only)"},
        requests=len(done), ok=len(done), output_tokens=toks,
        prompt_tokens=int(lengths.sum()), wall_s=wall, setup_s=setup_s,
        output_tok_s=toks / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_step_ms_median=median(st["step_ms"]["decode"]),
        mixed_step_ms_median=median(st["step_ms"]["mixed"]),
        prefill_sweep_ms_median=median(st["step_ms"]["prefill"]),
        prefill_sweeps=len(st["step_ms"]["prefill"]),
        prefill_utilization_mean=(float(np.mean(
            [w["utilization"] for w in sweeps])) if not eng.mixed else None),
        steps=st["steps"], mixed_steps=st["mixed_steps"],
        slot_utilization=st["slot_utilization"],
        kv_memory_ratio=st["kv_memory_ratio"],
        kv_blocks_visited=st["kv_blocks_visited"],
        kv_bytes_per_token=st["kv_bytes_per_token"],
        weight_bytes_per_step=st["weight_bytes_per_step"],
        bytes_per_token=st["bytes_per_token"], launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return summary, launches


def phase_serve(torch, np, full_cfg, engine_kw):
    """The mixed-step serve, then the three phase-serialized serves on the
    same params (contiguous bf16, contiguous int8, the default kv_quant
    engine: paged int8). Returns (mixed summary, launches per serve)."""
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(full_cfg)
    params = model.init(seed=0)
    init_s = time.perf_counter() - t0
    summary, launches = serve_run(torch, np, model, params, engine_kw)
    line("serve", seconds=round(time.perf_counter() - t0, 3),
         init_s=init_s, **summary)
    runs = {"mixed": launches}
    qmodel = Model(dataclasses.replace(full_cfg, kv_quant=True))
    kv_bytes = {}
    for label, m, kw in (("contiguous_bf16", model,
                          dict(paged=False, mixed=False)),
                         ("contiguous_int8", qmodel, dict(paged=False)),
                         ("paged_int8", qmodel, {})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        ser, runs[label] = serve_run(torch, np, m, params, engine_kw, **kw)
        if ser["engine"] != "serialized":
            fail(f"{label}: the {ser['engine']} engine served it")
        kv_bytes[label] = (ser["kv_bytes_per_token"],
                           ser["kv_blocks_visited"])
        line("serve_serialized", label=label,
             seconds=round(time.perf_counter() - t1, 3), **ser)
    # int8 lanes move (D + 4) / (2 D) of the bf16 lanes' K/V bytes at equal
    # visited blocks
    D = full_cfg.head_dim
    ratios = {}
    for label in ("contiguous_int8", "paged_int8"):
        if kv_bytes[label][1] != kv_bytes["contiguous_bf16"][1]:
            fail(f"{label}: visited blocks differ from the bf16 serve's "
                 f"{kv_bytes}")
        ratios[label] = kv_bytes[label][0] / kv_bytes["contiguous_bf16"][0]
        if abs(ratios[label] - (D + 4) / (2 * D)) > 1e-9:
            fail(f"{label}: kv bytes/token ratio {ratios[label]} != "
                 f"{(D + 4) / (2 * D)}")
    line("serve_serialized_kv_bytes", ratio_vs_contiguous_bf16=ratios,
         expected=(D + 4) / (2 * D))
    del params
    return summary, runs


def phase_compressed_serve(torch, np, ccfg, engine_kw, dense):
    """The main path on compressed weights: factorized f32 weights drawn
    on the card, projected and compressed there, the f32 tree freed, then
    the phase-4 workload."""
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(ccfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    params = project_wd_leaves(params, ccfg.factorization)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    mc, cparams, stats = model.compress_params(params)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t1
    del params  # the f32 factors; cparams shares only embeddings and head
    gc.collect()
    summary, launches = serve_run(
        torch, np, mc, cparams, engine_kw,
        weight_stream_bits=stats["weight_stream_bits"])
    del cparams
    n_lin = 7 * ccfg.n_layers * summary["steps"]
    if not launches["dmm_matmul"] == launches["smm_matmul"] == n_lin:
        fail(f"dmm/smm launches {launches} != 7 linears x "
             f"{ccfg.n_layers} layers x {summary['steps']} steps")
    # Decode steps (M = num_slots <= 32) run the small-M bodies, mixed steps
    # (M = num_slots x chunk) the tensor-core bodies, and nothing else.
    n_mixed = 7 * ccfg.n_layers * summary["mixed_steps"]
    want = {f"{k}.{b}": n for k in ("dmm_matmul", "smm_matmul")
            for b, n in (("small", n_lin - n_mixed), ("tc", n_mixed),
                         ("fma", 0))}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"dmm/smm launches by body "
             f"{ {k: launches[k] for k in want} }, want {want}")
    line("compressed_serve", seconds=round(time.perf_counter() - t0, 3),
         init_s=init_s, project_s=project_s, compress_s=compress_s,
         weight_stream_bits=stats["weight_stream_bits"],
         weight_stream_bits_dense=stats["weight_stream_bits_dense"],
         weight_compression_ratio=stats["weight_compression_ratio"],
         dense_weight_bytes_per_step=dense["weight_bytes_per_step"],
         dense_bytes_per_token=dense["bytes_per_token"],
         dense_output_tok_s=dense["output_tok_s"], **summary)
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
    from repro_torch.launch.profile_serve import (ENGINE_KW,
                                                  compressed_config,
                                                  serve_config)
    full_cfg, ccfg, engine_kw = serve_config(), compressed_config(), ENGINE_KW

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch, np, full_cfg, engine_kw)
    rows += timed("afu", phase_afu, torch)
    rows += timed("linear_kernels", phase_linear_kernels, torch, np, ccfg)
    table_launches = timed("kernel_table", phase_kernel_table, torch)
    timed("tokens", phase_tokens, torch)
    dense, runs = timed("serve", phase_serve, torch, np, full_cfg,
                        engine_kw)
    claunches = timed("compressed_serve", phase_compressed_serve, torch, np,
                      ccfg, engine_kw, dense)
    # Each kernel's launches come from the run that drives it, named in the
    # row's ``launches_from``: the TDA kernels' from the phase-4 serves (the
    # int8 rows from the int8 serves), DMM's and SMM's from phase 5, the LUT
    # softmax's from the kernel_table phase; the rows of no serve's path
    # (LayerNorm, the LUT and int8-mixed TDA variants) carry the launches of
    # their check at the row's full-width shape ("check").
    source = {"tda_paged_decode_attention": ("mixed", None),
              "tda_mixed_attention": ("mixed", None),
              "tda_decode_attention": ("contiguous_bf16", None),
              "tda_decode_attention.int8": ("contiguous_int8",
                                            "tda_decode_attention"),
              "tda_paged_decode_attention.int8": (
                  "paged_int8", "tda_paged_decode_attention")}
    for r in rows:
        if r["name"] in ("dmm_matmul", "smm_matmul"):
            r.update(launches=claunches[r["name"]],
                     launches_from="compressed_serve",
                     body_launches={k: v for k, v in claunches.items()
                                    if k.startswith(r["name"] + ".")})
        elif r["name"] == "softmax_lut":
            r.update(launches=table_launches["softmax_lut"],
                     launches_from="kernel_table")
        elif r["name"] in source:
            run, key = source[r["name"]]
            r.update(launches=runs[run][key or r["name"]],
                     launches_from=f"serve:{run}")
        if not r.get("launches"):
            fail(f"{r['name']} was not launched by the run that drives it")
    line("seconds", total=round(sum(seconds.values()), 3), **seconds)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + (
        "device_ms", "library_device_ms", "library_bf16_ms", "M8",
        "body_launches", "other_shapes") if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

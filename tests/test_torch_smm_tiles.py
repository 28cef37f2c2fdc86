"""SMM's and DMM's redesigned bodies, emulated in plain PyTorch on the CPU.

The CUDA bodies (``kernels/csrc/smm.cu``, ``kernels/csrc/dmm.cu``) cannot
run here, so their arithmetic and their walks are written out in plain
PyTorch and held against the kernels' plain versions:

* SMM's tensor-core body (M > 32) multiplies ``y_hi W_hi + y_lo W_hi +
  y_hi W_lo`` (bf16 parts, f32 sums): within the card check's limit (1e-3
  x max(1, max |plain|)) with a wide margin at the full width (r 3200,
  nnz 400), where one bf16 pass, and either two-pass split, miss it.
* Its producer densifies each K tile of 64 rows by one cursor per column
  that only moves forward (uint8 deltas never decrease): every tile equals
  the matching rows of ``densify``, through zero deltas (duplicates, summed
  before the split), indices at or past r, a negative first index, nnz 1
  and r no multiple of 64.
* SMM's small-M body splits each column's nnz into 512 / tile-width
  splits per chunk; a split's start index is the scan of the other
  splits' delta sums, and the splits merge in split order.
* DMM's small-M body splits K into block chunks (``small_plan``), the 8
  warps of a block take its 16-deep steps in turn and merge in warp order,
  and the splits merge in split order in the same launch.

Inputs come from numpy seeds.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

LIMIT = 1e-3  # chip_smoke.py's DMM/SMM limit, times max(1, max |plain|)
MERGE_TOL = 1e-5  # f32 sums in another order over a few hundred terms


def _parts(w: torch.Tensor, n: int):
    """f32 ``w`` -> n bf16 parts (as f32), each the rounding of the rest."""
    out = []
    for _ in range(n):
        part = w.to(torch.bfloat16).float()
        out.append(part)
        w = w - part
    return out


def _mm(a, b):
    """An f32 product of bf16-exact values, summed in f64 (the tensor cores'
    products are exact; only their f32 sums round)."""
    return (a.double() @ b.double()).float()


def _served_case(M=64, r=3200, N=256, nnz=400, seed=0):
    """y at the scale of DMM's outputs (a bf16 x through a 4-bit W_S, as
    the compressed linear feeds SMM) and the uint8 streams of a W_D
    compressed by the port, at the served rank and nnz."""
    from repro_torch.core import compression as comp
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm.ref import dmm_reference
    rng = np.random.default_rng(seed)
    K = 512
    cws = comp.compress_ws(tp.t(rng.standard_normal((K, r)).astype(
        np.float32) / math.sqrt(K)))
    x = tp.t(rng.standard_normal((M, K)).astype(np.float32), dtype=torch.bfloat16)
    y = dmm_reference(x, pack_nibbles(cws.codes), cws.lut)
    c = comp.compress_wd(tp.t(rng.standard_normal((r, N)).astype(np.float32)),
                         nnz)
    assert c.achieved_delta_bits <= 8
    return y, (c.deltas[0], c.deltas[1:].to(torch.uint8), c.values_q, c.scale,
               c.offset, 6)


def test_smm_three_bf16_passes_meet_the_limit():
    """The tensor-core body's split: three passes stay far inside the limit
    (<= 1/20 of it); one pass and both two-pass splits miss it."""
    from repro_torch.kernels.smm.ref import densify, smm_reference
    y, st = _served_case()
    plain = smm_reference(y, *st)
    limit = LIMIT * max(1.0, plain.abs().max().item())
    (yh, yl), (wh, wl) = _parts(y, 2), _parts(densify(*st[:5], y.shape[1],
                                                      st[5]), 2)
    err = {name: (z - plain).abs().max().item() for name, z in (
        ("three", _mm(yh, wh) + _mm(yl, wh) + _mm(yh, wl)),
        ("one", _mm(yh, wh)),
        ("y_split", _mm(yh, wh) + _mm(yl, wh)),
        ("w_split", _mm(yh, wh) + _mm(yh, wl)))}
    assert err["three"] <= limit / 20, (err, limit)
    for name in ("one", "y_split", "w_split"):
        assert err[name] > limit, (name, err, limit)


def _tile_walk(first, deltas, vq, scale, offset, bits, r, bk=64):
    """The producer's walk: per column a cursor (entry, index) that each K
    tile [k0, k0 + bk) advances past the entries below its end; entries in
    the tile are summed per index (duplicates are adjacent), then written
    once. Yields (k0, dense (bk, N) tile)."""
    from repro_torch.kernels.smm.ref import dequant_values
    vals = dequant_values(vq, scale, offset, bits)
    nnz, N = vq.shape
    pos = [0] * N
    idx = [int(first[n]) for n in range(N)]
    for k0 in range(0, r, bk):
        kend = min(k0 + bk, r)
        tile = torch.zeros(bk, N)
        for n in range(N):
            while pos[n] < nnz and idx[n] < kend:
                if idx[n] >= k0:  # below k0: only negative indices
                    tile[idx[n] - k0, n] += vals[pos[n], n]
                pos[n] += 1
                if pos[n] < nnz:
                    idx[n] += int(deltas[pos[n] - 1, n])
        yield k0, tile


def _uint8_streams(rng, r, N, nnz, zero_share=0.3):
    """Sorted uint8 streams: a first index from -3 up, deltas with a share
    of zeros (repeated indices), long enough to run past r."""
    first = rng.integers(-3, 8, size=N).astype(np.int32)
    hi = max(2, min(255, 3 * r // max(nnz, 1)))
    d = rng.integers(0, hi, size=(max(nnz - 1, 0), N))
    d[rng.random(d.shape) < zero_share] = 0
    vq = rng.integers(0, 64, size=(nnz, N)).astype(np.uint8)
    return tp.t(first), tp.t(d.astype(np.uint8)), tp.t(vq)


@pytest.mark.parametrize("r,N,nnz", [(200, 12, 40), (130, 9, 1), (64, 5, 2),
                                     (250, 7, 90)])
def test_smm_tile_walk_equals_densify(r, N, nnz):
    """Each K tile the cursors build equals the matching rows of
    ``densify``: zero deltas add, indices < 0 and >= r never land, nnz 1
    (deltas of shape (0, N)) and r no multiple of 64 (the last tile's rows
    past r stay zero)."""
    from repro_torch.kernels.smm.ref import decode_indices, densify
    rng = np.random.default_rng(r + N + nnz)
    first, deltas, vq = _uint8_streams(rng, r, N, nnz)
    first[0] = -3
    st = (first, deltas, vq, 1.7, -0.4, 6)
    idx = decode_indices(first, deltas)
    if nnz > 2:  # the draw covers every edge the walk handles
        assert (idx < 0).any() and (idx >= r).any()
        assert (deltas == 0).any()
    dense = densify(*st[:5], r, st[5])
    n_tiles = 0
    for k0, tile in _tile_walk(*st, r):
        rows = min(64, r - k0)
        torch.testing.assert_close(tile[:rows], dense[k0:k0 + rows], rtol=0,
                                   atol=1e-6)
        assert not tile[rows:].any()
        n_tiles += 1
    assert n_tiles == -(-r // 64)


def _small_plan(M, r, nnz, N, dsize, smem_limit=232448, sms=132):
    """``smm.cu::small_plan``: (tile width cb, rows per split rt, chunks)."""
    fixed = 32 * r + 512 * 8 * 4 + 2 * 512 * 4 + 256 * 4
    per_rt = 3 * 512 * (dsize + 1)
    rt_fit = (smem_limit - fixed) // per_rt
    gy = -(-M // 8)
    best = None
    for cb in (32, 16):
        S = 512 // cb
        rt = min(32, rt_fit, max(1, -(-nnz // S)))
        smem = fixed + per_rt * rt
        per_sm = max(1, min(4, smem_limit // smem))
        tiles = -(-N // cb)
        gx = min(tiles, max(1, sms * per_sm // gy))
        cost = -(-tiles // gx) * cb
        if best is None or cost < best[0]:
            best = (cost, cb, rt, max(1, -(-nnz // (S * rt))))
    return best[1:]


def _small_gather(y, first, deltas, vq, scale, offset, bits, cb, rt):
    """The small-M body per column tile of cb columns: chunks of S rt stream
    rows (S = 512 / cb splits of rt rows); each split sums its deltas, its
    start is the chunk's carry plus the sums of the splits before it (a
    scan), it gathers y at its indices into per-split partials, and the
    partials merge in split order."""
    from repro_torch.kernels.smm.ref import dequant_values
    M, r = y.shape
    nnz, N = vq.shape
    S = 512 // cb
    D = torch.cat([torch.zeros(1, N, dtype=torch.int64),
                   deltas.to(torch.int64)])  # D[k], D[0] = 0
    vals = dequant_values(vq, scale, offset, bits)
    out = torch.zeros(M, N)
    for n0 in range(0, N, cb):
        cols = slice(n0, min(n0 + cb, N))
        acc = torch.zeros(S, M, cols.stop - n0)
        carry = first[cols].to(torch.int64)
        for k0 in range(0, nnz, S * rt):
            sums = torch.stack([D[min(k0 + s * rt, nnz):
                                  min(k0 + (s + 1) * rt, nnz), cols].sum(0)
                                for s in range(S)])
            start = carry + torch.cumsum(sums, 0) - sums  # exclusive scan
            carry = carry + sums.sum(0)
            for s in range(S):
                idx = start[s].clone()
                for k in range(k0 + s * rt, min(k0 + (s + 1) * rt, nnz)):
                    idx += D[k, cols]
                    ok = (idx >= 0) & (idx < r)
                    g = y[:, idx.clamp(0, r - 1)] * ok
                    acc[s] += g * vals[k, cols]
        total = acc[0]
        for s in range(1, S):
            total = total + acc[s]
        out[:, cols] = total
    return out


@pytest.mark.parametrize("M,r,N,nnz,dtype", [
    (8, 640, 70, 80, "uint8"), (3, 300, 40, 50, "int16"),
    (5, 200, 33, 1, "uint8"), (8, 3200, 48, 400, "uint8")])
def test_smm_small_split_merge_matches_plain(M, r, N, nnz, dtype):
    """The small-M body's plan (``small_plan``), scan, gather and split-order
    merge against ``smm_reference``; int16 deltas with negative values
    (the body does not assume sorted indices)."""
    from repro_torch.kernels.smm.ref import smm_reference
    rng = np.random.default_rng(M + r + N + nnz)
    if dtype == "uint8":
        first, deltas, vq = _uint8_streams(rng, r, N, nnz)
    else:
        first = tp.t(rng.integers(-3, r // 2, size=N).astype(np.int32))
        deltas = tp.t(rng.integers(-20, 2 * r // nnz, size=(nnz - 1, N)
                                   ).astype(np.int16))
        vq = tp.t(rng.integers(0, 64, size=(nnz, N)).astype(np.uint8))
    y = tp.t(rng.standard_normal((M, r)).astype(np.float32))
    st = (first, deltas, vq, 1.1, -0.3, 6)
    cb, rt, nch = _small_plan(M, r, nnz, N, 1 if dtype == "uint8" else 2)
    assert cb in (16, 32) and 1 <= rt <= 32
    plain = smm_reference(y, *st)
    got = _small_gather(y, *st, cb, rt)
    torch.testing.assert_close(got, plain, rtol=MERGE_TOL, atol=MERGE_TOL)


def test_smm_small_plan_at_the_served_shapes():
    """qwen2.5-32b's families at M = 8: every nnz in one chunk of 16 or 32
    splits, and 64 or more column tiles for the narrowest N (1024)."""
    for r, nnz, N in ((3200, 400, 27648), (3200, 400, 5120), (640, 80, 1024)):
        cb, rt, nch = _small_plan(8, r, nnz, N, 1)
        assert nch == 1 and (512 // cb) * rt >= nnz
        assert -(-N // cb) >= 64


def _dmm_small_plan(M, K, N, sms=132):
    """``dmm.cu::small_plan``: (splits, chunk)."""
    mpad = 8 * (1 if M <= 8 else 2 if M <= 16 else 4)
    tiles = -(-N // 128)
    kmax = max(128, ((48 * 1024) // (2 * mpad) - 8) // 128 * 128)
    xs, red = mpad * (kmax + 8) * 2, 8 * mpad * 128 * 4
    per_sm = 2 if 32768 + max(xs, red) <= 110 * 1024 else 1
    splits = max(per_sm * sms // tiles, -(-K // kmax))
    splits = max(1, min(splits, -(-K // 256)))
    chunk = -(-(-(-K // splits)) // 128) * 128
    return -(-K // chunk), chunk


def _dmm_small_merge(x, packed, lut):
    """The small-M DMM body's order: per K chunk, warp w takes the 16-deep
    steps w, w + 8, ...; the warps' partials add in warp order, the
    chunks' in split order."""
    from repro_torch.kernels.dmm.ref import unpack_nibbles
    M, K = x.shape
    w = lut[unpack_nibbles(packed).long()][:K]
    splits, chunk = _dmm_small_plan(M, K, packed.shape[1])
    parts = []
    for z in range(splits):
        kb, ke = z * chunk, min(K, (z + 1) * chunk)
        warps = [torch.zeros(M, w.shape[1]) for _ in range(8)]
        for st in range(-(-(ke - kb) // 16)):
            k = slice(kb + 16 * st, min(kb + 16 * st + 16, ke))
            warps[st % 8] += x[:, k].float() @ w[k]
        total = warps[0]
        for p in warps[1:]:
            total = total + p
        parts.append(total)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, splits


@pytest.mark.parametrize("M,K,N", [(8, 27648, 64), (1, 5120, 40),
                                   (7, 5121, 33), (32, 333, 48),
                                   (31, 127, 17)])
def test_dmm_small_k_merge_matches_plain(M, K, N):
    """DMM's small-M K split and in-launch merge against ``dmm_reference``:
    ffn_down's K (27648) splits into chunks, odd K keeps its pad row off
    the live x columns."""
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm.ref import dmm_reference
    rng = np.random.default_rng(M + K + N)
    codes = tp.t(rng.integers(0, 16, size=(K, N)).astype(np.uint8))
    lut = tp.t((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
        np.float32))
    x = tp.t(rng.standard_normal((M, K)).astype(np.float32),
             dtype=torch.bfloat16)
    packed = pack_nibbles(codes)
    got, splits = _dmm_small_merge(x, packed, lut)
    if K == 27648:
        assert splits > 1
    plain = dmm_reference(x, packed, lut)
    torch.testing.assert_close(got, plain, rtol=MERGE_TOL, atol=MERGE_TOL)


def test_dmm_small_plan_at_the_served_shapes():
    """At M = 8 the plan gives the families of N 3200 250 blocks (two per
    SM at most), the k/v projections (N 640) 100, and chunks whose x rows
    fit 48 KB."""
    for K, N in ((27648, 3200), (5120, 3200), (5120, 640)):
        splits, chunk = _dmm_small_plan(8, K, N)
        assert splits * -(-N // 128) == (250 if N == 3200 else 100)
        assert 8 * (chunk + 8) * 2 <= 48 * 1024
        assert (splits - 1) * chunk < K <= splits * chunk

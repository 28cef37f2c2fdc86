"""DMM and SMM parity: the port's ops (their kernel wrappers run the plain
versions on CPU tensors) against the reference's Pallas kernels in
interpret mode and its jnp oracles, over the sweep of
``tests/test_kernels.py``; plus, on a CUDA device only, each hand-written
kernel against its plain version.

Tolerances, each with its reason: both sides multiply the same f32 values
(bf16 ``x`` is widened exactly) and accumulate in f32, so only the
summation order differs over K <= 256 — atol/rtol 1e-5 (the reference's
own kernel-vs-oracle tests allow 1e-4..2e-2). The DMM -> SMM chain against
the unquantized product is bounded by the 4b/6b quantization noise, as in
the reference (mean relative error < 0.25).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

ATOL = RTOL = 1e-5
DMM_CASES = [(32, 64, 48), (64, 128, 96), (100, 60, 36), (32, 33, 16),
             (16, 256, 128), (128, 128, 128), (8, 64, 40), (1, 129, 20),
             (33, 97, 24)]
SMM_CASES = [(32, 64, 48, 8), (64, 128, 100, 16), (16, 32, 32, 2),
             (48, 96, 64, 24), (8, 1024, 40, 2), (1, 64, 24, 8),
             (33, 130, 20, 3), (40, 100, 36, 30)]


def _ws(K, N, seed):
    """Nibble-packed codes + LUT of a random W_S (numpy), compressed by
    the port (the compression tests hold it equal to the reference's; the
    card has no JAX)."""
    from repro_torch.core import compression as comp
    from repro_torch.core.factorized import pack_nibbles
    ws = np.random.default_rng(seed).normal(size=(K, N)).astype(
        np.float32) * 0.1
    cws = comp.compress_ws(tp.t(ws))
    return pack_nibbles(cws.codes).numpy(), cws.lut.numpy()


def _wd(r, N, nnz, seed, value_bits=6):
    """T-REX streams of a random W_D (numpy), compressed by the port:
    first int32, deltas uint8 (int16 when they need more than 8 bits), vq,
    scale, offset."""
    from repro_torch.core import compression as comp
    wd = np.random.default_rng(seed).normal(size=(r, N)).astype(np.float32)
    cwd = comp.compress_wd(tp.t(wd), nnz, value_bits=value_bits)
    ddt = torch.uint8 if cwd.achieved_delta_bits <= 8 else torch.int16
    return (cwd.deltas[0].numpy(), cwd.deltas[1:].to(ddt).numpy(),
            cwd.values_q.numpy(), np.float32(cwd.scale),
            np.float32(cwd.offset))


def _jax_dmm(x, packed, lut, xdtype):
    import jax.numpy as jnp
    from repro.kernels.dmm.ops import lut_matmul
    from repro.kernels.dmm.ref import dmm_reference
    jx = jnp.asarray(x).astype(jnp.bfloat16 if xdtype == "bfloat16"
                               else jnp.float32)
    kern = lut_matmul(jx, jnp.asarray(packed), jnp.asarray(lut), bm=16,
                      bn=16, bk=32, use_kernel=True, interpret=True)
    return np.asarray(kern), np.asarray(dmm_reference(jx, jnp.asarray(packed),
                                                      jnp.asarray(lut)))


def _jax_smm(y, first, deltas, vq, scale, offset, value_bits=6):
    import jax.numpy as jnp
    from repro.kernels.smm.ops import compressed_matmul
    from repro.kernels.smm.ref import smm_reference
    args = [jnp.asarray(a) for a in (y, first, deltas, vq)]
    kern = compressed_matmul(*args, scale, offset, value_bits=value_bits,
                             bm=8, bn=8, use_kernel=True, interpret=True)
    ref = smm_reference(*args, jnp.float32(scale), jnp.float32(offset),
                        value_bits)
    return np.asarray(kern), np.asarray(ref)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", DMM_CASES)
def test_dmm_matches_reference(M, K, N, xdtype):
    """Odd K (33: the pack pad row), ragged tiles, bf16 x."""
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.dmm.ops import lut_matmul
    packed, lut = _ws(K, N, M + K + N)
    x = np.random.default_rng(K).normal(size=(M, K)).astype(np.float32)
    jk, jr = _jax_dmm(x, packed, lut, xdtype)
    tx = tp.t(x, dtype=getattr(torch, xdtype))
    n0 = dmm.LAUNCHES["dmm_matmul"]
    got = lut_matmul(tx, tp.t(packed), tp.t(lut))
    assert dmm.LAUNCHES["dmm_matmul"] == n0  # plain version: no launch
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), jr, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), jk, atol=ATOL, rtol=RTOL)
    plain = lut_matmul(tx, tp.t(packed), tp.t(lut), use_kernel=False)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("M,r,N,nnz", SMM_CASES)
def test_smm_matches_reference(M, r, N, nnz):
    """Ragged tiles, nnz = 2, and int16 deltas (r = 1024, nnz = 2)."""
    from repro_torch.kernels.smm.ops import compressed_matmul
    first, deltas, vq, scale, offset = _wd(r, N, nnz, M + r)
    if r == 1024:
        assert deltas.dtype == np.int16
    y = np.random.default_rng(r).normal(size=(M, r)).astype(np.float32)
    jk, jr = _jax_smm(y, first, deltas, vq, scale, offset)
    got = compressed_matmul(tp.t(y), tp.t(first), tp.t(deltas), tp.t(vq),
                            float(scale), float(offset))
    np.testing.assert_allclose(got.numpy(), jr, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), jk, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("value_bits", [4, 5, 7])
def test_smm_non_default_value_bits(value_bits):
    """The level count follows the streamed width, passed as a number or
    as a 0-d int32 tensor (a layer's slice of ``wd_bits``)."""
    from repro.core import compression as comp
    from repro_torch.kernels.smm.ops import compressed_matmul
    M, r, N, nnz = 32, 64, 48, 8
    first, deltas, vq, scale, offset = _wd(r, N, nnz, value_bits, value_bits)
    y = np.random.default_rng(value_bits).normal(size=(M, r)).astype(
        np.float32)
    jk, jr = _jax_smm(y, first, deltas, vq, scale, offset, value_bits)
    for bits in (value_bits, torch.tensor(value_bits, dtype=torch.int32)):
        got = compressed_matmul(tp.t(y), tp.t(first), tp.t(deltas), tp.t(vq),
                                tp.t(scale), tp.t(offset), value_bits=bits)
        np.testing.assert_allclose(got.numpy(), jr, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), jk, atol=ATOL, rtol=RTOL)
    wd = np.random.default_rng(value_bits).normal(size=(r, N)).astype(
        np.float32)
    cwd = comp.compress_wd(wd, nnz, value_bits=value_bits)
    oracle = y @ np.asarray(comp.decompress_wd_dense(cwd))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-4)


def test_smm_drops_indices_outside_rows():
    """Indices at or past r (a large delta) and below 0 (a negative int16
    delta) are dropped, as the reference's compare-select kernel drops
    them; duplicate indices (a zero delta) add."""
    from repro_torch.kernels.smm.ops import compressed_matmul
    from repro_torch.kernels.smm.ref import densify
    M, r, N = 4, 16, 5
    first = np.array([0, 3, 15, 2, 5], np.int32)
    # row indices per column: [0 1 3], [3 23 24], [15 15 18], [2 -3 1],
    # [5 5 5]
    deltas = np.array([[1, 20, 0, -5, 0],
                       [2, 1, 3, 4, 0]], np.int16)
    vq = np.random.default_rng(0).integers(0, 64, size=(3, N)).astype(
        np.uint8)
    y = np.random.default_rng(1).normal(size=(M, r)).astype(np.float32)
    jk, _ = _jax_smm(y, first, deltas, vq, 1.5, -0.25)
    got = compressed_matmul(tp.t(y), tp.t(first), tp.t(deltas), tp.t(vq),
                            1.5, -0.25)
    np.testing.assert_allclose(got.numpy(), jk, atol=ATOL, rtol=RTOL)
    dense = densify(tp.t(first), tp.t(deltas), tp.t(vq), 1.5, -0.25, r)
    # column 4: index 5 three times -> one entry, the sum of three values
    assert int((dense[:, 4] != 0).sum()) == 1


def test_dmm_smm_chain_matches_factorized_product():
    """The paper's sequential MM through both ops vs the f32 product of
    the unquantized factors: bounded by 4b/6b quantization noise."""
    from repro.core import compression as comp
    from repro.core.factorized import pack_nibbles
    from repro_torch.core.sparsity import project_topk_columns
    from repro_torch.kernels.dmm.ops import lut_matmul
    from repro_torch.kernels.smm.ops import compressed_matmul
    rng = np.random.default_rng(0)
    M, K, r, N, nnz = 32, 64, 64, 48, 8
    ws = rng.normal(size=(K, r)).astype(np.float32) * 0.2
    wd = project_topk_columns(tp.t(rng.normal(size=(r, N)).astype(
        np.float32)), nnz).numpy()
    x = rng.normal(size=(M, K)).astype(np.float32)
    cws, cwd = comp.compress_ws(ws), comp.compress_wd(wd, nnz)
    y1 = lut_matmul(tp.t(x), tp.t(pack_nibbles(cws.codes)), tp.t(cws.lut))
    z = compressed_matmul(
        y1, tp.t(comp.delta_decode(cwd.deltas)[0].astype(np.int32)),
        tp.t(cwd.deltas[1:].astype(np.uint8)), tp.t(cwd.values_q),
        cwd.scale, cwd.offset)
    exact = (x @ ws) @ wd
    rel = np.abs(z.numpy() - exact).mean() / (np.abs(exact).mean() + 1e-9)
    assert rel < 0.25


def test_wrappers_check_shapes():
    from repro_torch.kernels.dmm.dmm import dmm_matmul
    from repro_torch.kernels.smm.smm import smm_matmul
    with pytest.raises(ValueError, match="rows"):
        dmm_matmul(torch.zeros(2, 8), torch.zeros(5, 3, dtype=torch.uint8),
                   torch.zeros(16))
    one = torch.tensor(1.0)
    with pytest.raises(ValueError, match="shape"):
        smm_matmul(torch.zeros(2, 8), torch.zeros(3, dtype=torch.int32),
                   torch.zeros(2, 4, dtype=torch.uint8),
                   torch.zeros(3, 4, dtype=torch.uint8), one, one,
                   torch.tensor(6, dtype=torch.int32))


def _gpu_edge_cases(xdtype):
    """(name, kernel thunk, plain thunk) over the CPU tests' edge cases on
    the card."""
    from repro_torch.kernels.dmm.ops import lut_matmul
    from repro_torch.kernels.smm.ops import compressed_matmul
    dev = torch.device("cuda")
    for M, K, N in DMM_CASES:
        packed, lut = _ws(K, N, M + K + N)
        x = np.random.default_rng(K).normal(size=(M, K)).astype(np.float32)
        args = (tp.t(x, dev, getattr(torch, xdtype)), tp.t(packed, dev),
                tp.t(lut, dev))
        yield ("dmm_matmul", lambda a=args: lut_matmul(*a),
               lambda a=args: lut_matmul(*a, use_kernel=False))
    for M, r, N, nnz in SMM_CASES:
        first, deltas, vq, scale, offset = _wd(r, N, nnz, M + r)
        y = np.random.default_rng(r).normal(size=(M, r)).astype(np.float32)
        args = [tp.t(a, dev) for a in (y, first, deltas, vq, scale, offset)]
        yield ("smm_matmul", lambda a=args: compressed_matmul(*a),
               lambda a=args: compressed_matmul(*a, use_kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(xdtype):
    """Each hand-written kernel against its plain version on the same inputs
    on the card: max abs diff <= 1e-3 x max(1, max |plain|) (f32 sums in
    another order), one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    counters = {"dmm_matmul": dmm.LAUNCHES, "smm_matmul": smm.LAUNCHES}
    for name, kernel, plain in _gpu_edge_cases(xdtype):
        n0 = counters[name][name]
        got = kernel()
        assert counters[name][name] == n0 + 1
        ref = plain()
        torch.cuda.synchronize()
        limit = 1e-3 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= limit, name


# Tile edges of the tensor-core DMM body (bf16 x, M > 32; 128 x 128
# outputs, K steps of 64): ragged M (33, 130), N (200: no multiple of 16,
# element copies), odd K, K no multiple of 64, split K (N = 640 at M =
# 2048), one full 2048 x 3200 output.
DMM_TILE_EDGES = [(33, 127, 200), (64, 4000, 640), (130, 513, 3200),
                  (2048, 5120, 640), (2048, 2088, 200), (130, 1000, 200),
                  (2048, 1000, 3200)]


@pytest.mark.gpu
def test_cuda_dmm_tensor_core_tile_edges():
    """The tensor-core DMM body at DMM_TILE_EDGES against its plain version
    on the card: max abs diff <= 1e-3 x max(1, max |plain|), one launch
    counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.dmm.ops import lut_matmul
    dev = torch.device("cuda")
    for M, K, N in DMM_TILE_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = tp.t(rng.integers(0, 16, size=(K, N)).astype(np.uint8), dev)
        lut = tp.t((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32), dev)
        x = tp.t(rng.standard_normal((M, K)).astype(np.float32), dev,
                 torch.bfloat16)
        packed = pack_nibbles(codes)
        n0 = dmm.LAUNCHES["dmm_matmul"]
        got = lut_matmul(x, packed, lut)
        assert dmm.LAUNCHES["dmm_matmul"] == n0 + 1
        ref = lut_matmul(x, packed, lut, use_kernel=False)
        torch.cuda.synchronize()
        limit = 1e-3 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= limit, (M, K, N)


# Edges of SMM's two redesigned bodies (as chip_smoke.py::SMM_TILE_EDGES):
# (M, r, N, nnz, kind). M 1-32 runs the small-M gather body (any delta
# type), M > 32 the tensor-core body for uint8 deltas and the first
# version's body for int16; N 1000 (ragged: element loads), r 650 (no
# multiple of the 64-row K tile), nnz 1 (no deltas), 2, 80 and 400, the
# full widths (N 27648 at M 8; r 3200, N 5120 at M 2048); "dup": uint8
# deltas with zeros (repeated indices), "neg": int16 deltas, some negative.
SMM_TILE_EDGES = [(1, 640, 1024, 80, "sorted"), (7, 3200, 5120, 400, "sorted"),
                  (8, 3200, 27648, 400, "sorted"), (31, 650, 1000, 2, "sorted"),
                  (32, 3200, 1024, 1, "sorted"), (8, 640, 1024, 80, "dup"),
                  (8, 640, 1000, 80, "neg"), (33, 640, 5120, 80, "sorted"),
                  (130, 3200, 1000, 400, "sorted"), (130, 640, 1024, 80, "dup"),
                  (130, 640, 1024, 80, "neg"),
                  (2048, 650, 1024, 2, "sorted"),
                  (2048, 3200, 5120, 400, "sorted")]
# Edges of DMM's small-M body (bf16 x, M <= 32): (M, K, N); odd K, K of
# ffn_down (27648), N of the k/v (640) and other (3200) families, ragged N.
DMM_SMALL_EDGES = [(1, 27648, 3200), (7, 5121, 640), (8, 27648, 640),
                   (31, 333, 3200), (32, 27648, 3200), (8, 4000, 200),
                   (16, 127, 48)]


def smm_edge_streams(rng, r, N, nnz, kind):
    """(first, deltas, vq) numpy streams: "sorted" and "dup" uint8 deltas
    (never negative; "dup" a third of them 0), indices from a first index
    of -2 up and running past r; "neg" int16 deltas, a tenth of them
    negative."""
    first = rng.integers(-2, max(1, r // 4), size=N).astype(np.int32)
    hi = max(1, min(255, 2 * r // max(nnz, 1)))
    d = rng.integers(0, hi + 1, size=(max(nnz - 1, 0), N))
    if kind == "dup":
        d[rng.random(d.shape) < 1 / 3] = 0
    if kind == "neg":
        d[rng.random(d.shape) < 0.1] -= 20
    vq = rng.integers(0, 64, size=(nnz, N)).astype(np.uint8)
    return first, d.astype(np.int16 if kind == "neg" else np.uint8), vq


def _smm_body(M, kind):
    return "small" if M <= 32 else "fma" if kind == "neg" else "tc"


@pytest.mark.gpu
def test_cuda_smm_body_edges():
    """SMM's bodies at SMM_TILE_EDGES against the plain version on the
    card: max abs diff <= 1e-3 x max(1, max |plain|), the launch counted
    against the body the shapes select, and a second launch on the same
    inputs bit-identical (the result does not depend on scheduling)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.smm.ops import compressed_matmul
    dev = torch.device("cuda")
    for M, r, N, nnz, kind in SMM_TILE_EDGES:
        rng = np.random.default_rng(M + r + N + nnz)
        st = [tp.t(a, dev) for a in smm_edge_streams(rng, r, N, nnz, kind)]
        y = tp.t(rng.standard_normal((M, r)).astype(np.float32), dev)
        args = (y, *st, 1.3, -0.6)
        key = f"smm_matmul.{_smm_body(M, kind)}"
        n0 = smm.BODY_LAUNCHES[key]
        got = compressed_matmul(*args)
        again = compressed_matmul(*args)
        assert smm.BODY_LAUNCHES[key] == n0 + 2, (M, r, N, nnz, kind)
        ref = compressed_matmul(*args, use_kernel=False)
        torch.cuda.synchronize()
        limit = 1e-3 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= limit, (M, r, N, nnz, kind)
        assert torch.equal(got, again), (M, r, N, nnz, kind)


@pytest.mark.gpu
def test_cuda_dmm_small_body_edges():
    """DMM's small-M body (bf16 x) at DMM_SMALL_EDGES against its plain
    version on the card: max abs diff <= 1e-3 x max(1, max |plain|), one
    launch of the small body per call, and a second launch bit-identical
    (the K splits merge in a fixed order and the counters reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.dmm.ops import lut_matmul
    dev = torch.device("cuda")
    for M, K, N in DMM_SMALL_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = tp.t(rng.integers(0, 16, size=(K, N)).astype(np.uint8), dev)
        lut = tp.t((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32), dev)
        x = tp.t(rng.standard_normal((M, K)).astype(np.float32), dev,
                 torch.bfloat16)
        packed = pack_nibbles(codes)
        n0 = dmm.BODY_LAUNCHES["dmm_matmul.small"]
        got = lut_matmul(x, packed, lut)
        again = lut_matmul(x, packed, lut)
        assert dmm.BODY_LAUNCHES["dmm_matmul.small"] == n0 + 2
        ref = lut_matmul(x, packed, lut, use_kernel=False)
        torch.cuda.synchronize()
        limit = 1e-3 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= limit, (M, K, N)
        assert torch.equal(got, again), (M, K, N)


@pytest.mark.gpu
@pytest.mark.parametrize("compressed_ws", [True, False])
def test_cuda_compressed_linear_launches_kernels(compressed_ws):
    """``apply_compressed_linear`` on a CUDA ``x``: W_D goes through the
    SMM kernel whether W_S is compressed (then through the DMM kernel too)
    or raw (a dense product); the result matches the explicit
    decompression to 1e-3 x max(1, max |plain|) (f32 sums in another
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core.factorized import (apply_compressed_linear,
                                             decompress_ws_entry)
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    dev = torch.device("cuda")
    K, r, N, nnz = 64, 32, 48, 8
    packed, lut = _ws(K, r, 11)
    cd = {"codes_packed": tp.t(packed, dev), "lut": tp.t(lut, dev)}
    if not compressed_ws:
        cd = decompress_ws_entry(cd, K)
    first, deltas, vq, scale, offset = _wd(r, N, nnz, 12)
    p = {"wd_first": tp.t(first, dev), "wd_deltas": tp.t(deltas, dev),
         "wd_vq": tp.t(vq, dev), "wd_scale": tp.t(scale, dev),
         "wd_offset": tp.t(offset, dev),
         "wd_bits": torch.tensor(6, dtype=torch.int32, device=dev)}
    x = tp.t(np.random.default_rng(13).normal(size=(2, 5, K)).astype(
        np.float32), dev)
    n_dmm, n_smm = dmm.LAUNCHES["dmm_matmul"], smm.LAUNCHES["smm_matmul"]
    got = apply_compressed_linear(p, x, {"f": cd}, "f",
                                  compute_dtype=torch.float32)
    assert smm.LAUNCHES["smm_matmul"] == n_smm + 1
    assert dmm.LAUNCHES["dmm_matmul"] == n_dmm + int(compressed_ws)
    ref = apply_compressed_linear(p, x, {"f": cd}, "f",
                                  compute_dtype=torch.float32,
                                  use_kernel=False)
    torch.cuda.synchronize()
    limit = 1e-3 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= limit

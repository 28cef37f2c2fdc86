"""``kernels/tda/sharded.py::sharded_decode_attention`` on 2 and 4 gloo
ranks on the CPU (``launch.mesh.run_ranks``; each rank holds its block of
kv heads; one spawn of four ranks runs a ``(1, 4)`` mesh, then a ``(2,
2)`` one whose two model axes of 2 ranks each run the 2-rank cases)
against the reference's dense ``decode_attention`` with ``mesh=None``
over every head, at float32: contiguous lanes, paged lanes
(a shuffled pool behind a block table), int8 codes with their scales and a
sliding window, each batch holding a slot that attends nothing. Limits:
1e-5 (``ATOL_ATTN``: the same f32 products, another summation order), the
empty slot exactly 0 (the reference's sharded contract: ``0 / eps``), and
every rank's output bitwise equal to every other's. The ``gpu`` twin runs
the decode kernel's partials (``acc = o``, ``m = 0``, ``l = 1``) on the
card, two ranks sharing it through gloo."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

B, HQ, HKV, D, S, PS = 4, 8, 4, 16, 40, 8
LENGTHS = np.array([7, 40, 23, 0], np.int32)  # slot 3 attends nothing


def _cases():
    """name -> (case for the ranks, dense lanes for the reference)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    kp, vp, bt, _ = tp.paged_pool(rng, B=B, Hkv=HKV, D=D, ps=PS, n=S // PS,
                                  free_tail=False)
    scale_k = (np.abs(k).max(-1) + 1e-6) / 127.0
    scale_v = (np.abs(v).max(-1) + 1e-6) / 127.0
    kq = np.clip(np.round(k / scale_k[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(v / scale_v[..., None]), -127, 127).astype(np.int8)
    base = dict(q=q, lengths=LENGTHS)
    return {
        "contiguous": (dict(base, k=k, v=v), dict(k=k, v=v)),
        "paged": (dict(base, k=kp, v=vp, bt=bt),
                  dict(k=kp[bt].reshape(B, S, HKV, D),
                       v=vp[bt].reshape(B, S, HKV, D))),
        "int8": (dict(base, k=kq, v=vq, k_scale=scale_k.astype(np.float32),
                      v_scale=scale_v.astype(np.float32)),
                 dict(k=kq, v=vq, k_scale=scale_k.astype(np.float32),
                      v_scale=scale_v.astype(np.float32))),
        "window": (dict(base, k=k, v=v, window=8), dict(k=k, v=v, window=8)),
    }


NAMES = ["contiguous", "paged", "int8", "window"]
# Tensor-parallel sizes and the grid of four ranks that runs them: N = 4 on
# (1, 4); N = 2 on (2, 2), whose two rows are two 2-rank model axes.
SHAPES = {4: (1, 4), 2: (2, 2)}
_RUNS: dict = {}


def _ranks(n: int):
    """Every rank's outputs of every case at tensor-parallel size ``n``,
    from one spawn of four ranks for both sizes."""
    if not _RUNS:
        from repro_torch.launch.mesh import run_ranks
        cases = _cases()
        res = run_ranks(4, tp.rank_sharded_decode, tuple(SHAPES.values()),
                        [cases[c][0] for c in NAMES], device="cpu",
                        backend="gloo")
        _RUNS.update({k: [r[shape] for r in res]
                      for k, shape in SHAPES.items()})
    return _RUNS[n]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_decode_matches_reference(name, n):
    import jax.numpy as jnp
    from repro.models.layers import decode_attention
    case, lanes = _cases()[name]
    outs = [r[NAMES.index(name)] for r in _ranks(n)]
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])
    got = outs[0]
    ref = np.asarray(decode_attention(
        jnp.asarray(case["q"]), jnp.asarray(lanes["k"]),
        jnp.asarray(lanes["v"]), jnp.asarray(LENGTHS),
        window=lanes.get("window"),
        k_scale=None if "k_scale" not in lanes
        else jnp.asarray(lanes["k_scale"]),
        v_scale=None if "v_scale" not in lanes
        else jnp.asarray(lanes["v_scale"]), impl="dense"))
    live = LENGTHS > 0
    np.testing.assert_allclose(got[live], ref[live], rtol=0,
                               atol=tp.ATOL_ATTN)
    assert np.all(got[~live] == 0.0)


@pytest.mark.gpu
def test_cuda_sharded_decode_kernel_partials():
    """On the card: two gloo ranks sharing it run the decode kernel on
    their heads (contiguous, paged and int8 lanes, a window); every rank's
    output equals the others' and the plain oracle's over every head
    (``kernels/tda/ref.py``, on the CPU) within 1e-3, chip_smoke.py's
    limit for the exact-exp TDA kernels; the empty slot gives 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel runs on the card")
    from repro_torch.kernels.tda.ref import decode_attention_reference
    from repro_torch.launch.mesh import run_ranks
    cases = _cases()
    runs = [r[(1, 2)] for r in run_ranks(
        2, tp.rank_sharded_decode, ((1, 2),),
        [cases[c][0] for c in NAMES],
        backend="gloo")]
    for i, name in enumerate(NAMES):
        case, lanes = cases[name]
        got = runs[0][i]
        assert np.array_equal(got, runs[1][i])
        ref = decode_attention_reference(
            tp.t(case["q"]), tp.t(lanes["k"]), tp.t(lanes["v"]),
            tp.t(LENGTHS), window=lanes.get("window"),
            k_scale=None if "k_scale" not in lanes else tp.t(lanes["k_scale"]),
            v_scale=None if "v_scale" not in lanes
            else tp.t(lanes["v_scale"])).numpy()
        live = LENGTHS > 0
        np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=1e-3)
        assert np.all(got[~live] == 0.0)

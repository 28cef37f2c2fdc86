"""The tensor-core kernels' split arithmetic, emulated in plain PyTorch on
the CPU.

The bf16 tensor cores multiply bf16 operands exactly into an f32 sum, so a
kernel that feeds them an f32 operand splits it into bf16 parts, one
product each:

* DMM (``kernels/csrc/dmm.cu``, M > 32): ``x W_hi + x W_lo`` with ``W_hi =
  bf16(lut)`` and ``W_lo = bf16(lut - W_hi)``, held to the card check's
  limit against ``dmm_reference`` (1e-3 x max(1, max |plain|)); a single
  bf16 pass must miss that limit.
* Mixed TDA (``kernels/csrc/tda_mixed.cu``, bf16 q): QK^T exact (bf16 q and
  keys, int8 codes exact in bf16), the key scale on the score, P times the
  value scale, split into two bf16 parts (three in the LUT mode), times the
  bf16 values; held to 1e-5 against ``mixed_attention_reference`` on
  spread and peaked scores; a single bf16 P must miss the exact mode's 1e-3
  on peaked scores.

Inputs come from numpy seeds; every product is an f32 CPU matmul of
bf16-exact values, as the tensor cores compute it (the kernels sum in
another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

DMM_TOL = 1e-3   # chip_smoke.py's DMM limit, times max(1, max |plain|)
MIXED_TOL = 1e-5  # the LUT TDA limit; the exact mode's is 1e-3


def _parts(w: torch.Tensor, n: int):
    """f32 ``w`` -> n bf16 parts (as f32), each the rounding of the rest."""
    out = []
    for _ in range(n):
        part = w.to(torch.bfloat16).float()
        out.append(part)
        w = w - part
    return out


def _dmm_case(M, K, N, seed):
    from repro_torch.core.factorized import pack_nibbles
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 16, size=(K, N)).astype(
        np.uint8))
    lut = torch.from_numpy(np.sort(rng.standard_normal(16)).astype(
        np.float32)) / math.sqrt(K)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(
        np.float32)).to(torch.bfloat16)
    return x, pack_nibbles(codes), lut


def _dmm_split(x, packed, lut, n_parts):
    """The tensor-core body's arithmetic: the LUT split into n_parts bf16
    tables, one f32-accumulated product of the bf16 x each."""
    from repro_torch.kernels.dmm.ref import unpack_nibbles
    idx = unpack_nibbles(packed).long()[:x.shape[1]]
    out = torch.zeros(x.shape[0], packed.shape[1])
    for part in _parts(lut, n_parts):
        out = out + x.float() @ part[idx]
    return out


@pytest.mark.parametrize("K", [27648, 5120])
def test_dmm_two_bf16_passes_meet_the_limit(K):
    """ffn_down's K (27648) and the other families' (5120): two passes stay
    far inside the limit, one pass misses it."""
    from repro_torch.kernels.dmm.ref import dmm_reference
    x, packed, lut = _dmm_case(256, K, 512, K)
    plain = dmm_reference(x, packed, lut)
    limit = DMM_TOL * max(1.0, plain.abs().max().item())
    two = (_dmm_split(x, packed, lut, 2) - plain).abs().max().item()
    one = (_dmm_split(x, packed, lut, 1) - plain).abs().max().item()
    assert two <= limit / 20, (two, limit)
    assert one > limit, (one, limit)


def _mixed_inputs(seed, peaked, quant, n_cache=800, D=128, G=5):
    """One mixed-step row: G query heads of one kv head at column j = 0,
    n_cache pool keys (ci = ring = n_cache) and the row's own chunk key;
    ``peaked`` scales q by 4. Returns (q, k, v, kr, vr, ks, vs) with the
    pool as int8 codes + scales when ``quant``."""
    from repro_torch.models.layers import kv_quantize
    rng = np.random.default_rng(seed)

    def bf(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(torch.bfloat16)

    q = bf((1, 1, G, D), 4.0 if peaked else 1.0)
    k, v = bf((1, n_cache, 1, D)), bf((1, n_cache, 1, D))
    kr, vr = bf((1, 1, 1, D)), bf((1, 1, 1, D))
    if not quant:
        return q, k, v, kr, vr, None, None
    (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
    return q, kq, vq, kr, vr, ks, vs


def _mixed_split(q, k, v, kr, vr, ks, vs, n_parts):
    """The tensor-core body's arithmetic for the row: exact bf16 QK^T in
    f32, times the f32 scale and the key scale (1 for chunk keys), an f32
    softmax, P times the value scale split into n_parts bf16 parts, each
    times the bf16 values (int8 codes exactly)."""
    D = q.shape[-1]
    keys = torch.cat([k[0, :, 0].float(), kr[0, :, 0].float()])
    vals = torch.cat([v[0, :, 0].float(), vr[0, :, 0].float()])
    one = torch.ones(kr.shape[1])
    ksc = torch.cat([ks[0, :, 0], one]) if ks is not None else 1.0
    vsc = torch.cat([vs[0, :, 0], one]) if vs is not None else 1.0
    s = (q[0, 0].float() @ keys.T) * (1.0 / math.sqrt(D)) * ksc
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    out = sum(part @ vals for part in _parts(p * vsc, n_parts))
    return (out / p.sum(-1, keepdim=True))[None, None]


def _mixed_plain(q, k, v, kr, vr, ks, vs):
    from repro_torch.kernels.tda.ref import mixed_attention_reference
    n = k.shape[1]
    return mixed_attention_reference(
        q, k, v, kr, vr, torch.tensor([n]), torch.tensor([1]), ring=n,
        k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_mixed_split_p_matches_plain(n_parts, peaked, quant):
    """P in two bf16 parts (the exact mode) and three (the LUT mode), with
    the int8 scales folded as the kernel folds them, within 1e-5 of the
    mixed plain version."""
    args = _mixed_inputs(7 + quant, peaked, quant)
    plain = _mixed_plain(*args)
    got = _mixed_split(*args, n_parts)
    assert (got - plain).abs().max().item() <= MIXED_TOL


def test_mixed_single_bf16_p_misses_the_exact_limit():
    """The control: one bf16 P (times the value scales of an int8 pool) on
    peaked scores misses even the exact mode's 1e-3."""
    args = _mixed_inputs(8, True, True)
    err = (_mixed_split(*args, 1) - _mixed_plain(*args)).abs().max().item()
    assert err > 1e-3, err

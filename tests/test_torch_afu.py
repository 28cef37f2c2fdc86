"""AFU parity: the port's LUT exp, its LUT-exp softmax and its fused
residual + LayerNorm (the kernel wrappers run their plain versions on CPU
tensors) against the reference's table, ``lut_exp`` and Pallas kernels in
interpret mode; plus, on a CUDA device only, each hand-written kernel
against its plain version.

Tolerances, each with its reason: the table and ``lut_exp`` are the same
f32 formulas (exp itself may differ by an ulp between libraries): rtol
1e-6 and atol 1e-7. Softmax at f32: the same exps, summed in another
order: rtol 1e-5, atol 1e-6 (the reference test's own); bf16 input is
widened exactly on both sides: atol 1e-3. LayerNorm: mean and variance
summed in another order, ``1/sqrt`` against ``rsqrt``: rtol 1e-4, atol
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

SOFTMAX_SHAPES = [(8, 16), (33, 50), (256, 128), (7, 999), (2, 3, 40)]


def test_exp_lut_table_matches_reference():
    from repro.kernels.afu.ref import exp_lut_table as jtable
    from repro_torch.kernels.afu.ref import LUT_SIZE, exp_lut_table
    got = exp_lut_table()
    assert got.dtype == torch.float32 and got.shape == (LUT_SIZE,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtable()), rtol=1e-6,
                               atol=0)


def test_lut_exp_clamps_like_reference():
    """Below -16 the LUT clamps to table[0] = exp(-16), about 1.1e-7: it
    does not flush to 0 (masked keys reach 0 only through the mask)."""
    import jax.numpy as jnp
    from repro.kernels.afu.ref import exp_lut_table as jtable
    from repro.kernels.afu.ref import lut_exp as jlut
    from repro_torch.kernels.afu.ref import exp_lut_table, lut_exp
    x = np.concatenate([np.linspace(-20.0, 0.0, 257), [-1e30]]).astype(
        np.float32)
    table = exp_lut_table()
    got = lut_exp(tp.t(x), table).numpy()
    ref = np.asarray(jlut(jnp.asarray(x), jtable()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    assert got[-1] == table[0].item() > 1e-7
    assert got[256] == 1.0  # lut(0) is exactly 1


def _lut_exp_mirror(x, table, divide):
    """``kernels/csrc/lut_exp.cuh``'s steps in numpy f32, one rounding each:
    (xc + 16) scaled by ``/ 16`` (the reference's form) or ``* (1 / 16)``
    (the header's), then both of the header's table reads: the table, and
    its pairs {t[i], t[i + 1] - t[i]}."""
    f32 = np.float32
    xc = np.minimum(np.maximum(x, f32(-16)), f32(0))
    h = xc + f32(16)
    f = (h / f32(16) if divide else h * (f32(1) / f32(16))) * f32(63)
    i0 = np.clip(np.floor(f).astype(np.int32), 0, 62)
    frac = f - i0.astype(f32)
    lo = table[i0]
    by_table = lo + (table[i0 + 1] - lo) * frac
    pairs = np.stack([table[:-1], table[1:] - table[:-1]], 1)
    by_pairs = pairs[i0, 0] + pairs[i0, 1] * frac
    return by_table, by_pairs


def test_lut_exp_multiply_form_is_bit_identical():
    """The header scales by the exact reciprocal 1/16 where the reference
    divides by 16: a power of two, so both round the same real number. Over
    a dense sweep of [-16, 0], the table's knots and their neighbours, and
    the edges (-0.0, -16, below -16), the multiply form, the divide form,
    both table reads and the port's ``ref.lut_exp`` give the same bits."""
    from repro_torch.kernels.afu.ref import exp_lut_table, lut_exp
    f32 = np.float32
    knots = (np.arange(64, dtype=f32) * f32(16 / 63) - f32(16)).astype(f32)
    x = np.concatenate([
        np.linspace(-16.0, 0.0, 1 << 21, dtype=f32),
        knots, np.nextafter(knots, f32(-np.inf)),
        np.nextafter(knots, f32(np.inf)),
        np.array([-0.0, 0.0, -16.0, np.nextafter(f32(-16), f32(-17)),
                  -17.0, -1e30, -np.inf], f32)]).astype(f32)
    x = x[x <= 0]
    table = exp_lut_table().numpy()
    mul, mul_pairs = _lut_exp_mirror(x, table, divide=False)
    div, div_pairs = _lut_exp_mirror(x, table, divide=True)
    bits = [a.view(np.uint32) for a in (mul, mul_pairs, div, div_pairs)]
    for b in bits[1:]:
        np.testing.assert_array_equal(b, bits[0])
    ref = lut_exp(torch.from_numpy(x), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), bits[0])
    assert mul[x == 0].min() == 1.0 and mul[-1] == table[0]


def test_softmax_regimes_mirror_the_cuda_source():
    """``afu.softmax_regime`` (the launch counts by regime) mirrors the
    boundaries that ``kernels/csrc/afu.cu`` picks by C."""
    import pathlib
    import re
    from repro_torch.kernels.afu import afu
    src = (pathlib.Path(afu.__file__).parents[1] / "csrc" / "afu.cu"
           ).read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([0-9 *]+);", src)
        return int(np.prod([int(t) for t in m.group(1).split("*")]))

    assert (const("kWarpMaxC"), const("kBlockMaxC"), const("kCluster"),
            const("kSliceMax")) == (afu.WARP_MAX_C, afu.BLOCK_MAX_C,
                                    afu.CLUSTER, afu.SLICE_MAX)
    cap = afu.CLUSTER * afu.SLICE_MAX
    got = [afu.softmax_regime(C) for C in (
        1, afu.WARP_MAX_C, afu.WARP_MAX_C + 1, afu.BLOCK_MAX_C,
        afu.BLOCK_MAX_C + 1, 152064, 256000, cap, cap + 1, 600001)]
    assert got == ["warp"] * 2 + ["block"] * 2 + ["cluster"] * 4 + [
        "cluster_reread"] * 2


def test_plain_softmax_matches_reference_kernel_vocab_rows():
    """The plain version (the wrappers' CPU path and the card's oracle) at
    rows as wide as qwen2.5's LM head, against the reference's Pallas
    kernel in interpret mode, under the f32 tolerances above."""
    import jax.numpy as jnp
    from repro.kernels.afu.ops import fused_softmax as jsoftmax
    from repro_torch.kernels.afu.ops import fused_softmax
    x = (np.random.default_rng(152064).normal(size=(3, 152064)) * 4).astype(
        np.float32)
    ref = np.asarray(jsoftmax(jnp.asarray(x), interpret=True))
    got = fused_softmax(tp.t(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES)
def test_fused_softmax_matches_reference(shape):
    import jax.numpy as jnp
    from repro.kernels.afu.ops import fused_softmax as jsoftmax
    from repro_torch.kernels.afu.ops import fused_softmax
    x = (np.random.default_rng(sum(shape)).normal(size=shape) * 4).astype(
        np.float32)
    ref = np.asarray(jsoftmax(jnp.asarray(x)))
    for use_kernel in (True, False):
        got = fused_softmax(tp.t(x), use_kernel=use_kernel)
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    ref_bf = np.asarray(jsoftmax(jnp.asarray(x).astype(jnp.bfloat16)))
    got_bf = fused_softmax(tp.t(x, dtype=torch.bfloat16))
    assert got_bf.dtype == torch.float32
    np.testing.assert_allclose(got_bf.numpy(), ref_bf, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(40, 64), (7, 999)])
def test_fused_layernorm_residual_matches_reference(shape):
    import jax.numpy as jnp
    from repro.kernels.afu.ops import fused_layernorm_residual as jln
    from repro_torch.kernels.afu.ops import fused_layernorm_residual
    rng = np.random.default_rng(shape[1])
    x, res = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    ref = np.asarray(jln(*(jnp.asarray(a) for a in (x, res, scale, bias))))
    got = fused_layernorm_residual(*(tp.t(a) for a in (x, res, scale, bias)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_wrappers_run_plain_versions_on_cpu_and_check_inputs():
    """The CPU path never launches and never counts; bad dtypes on the
    kernel path raise before any launch."""
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import exp_lut_table
    afu.reset_launch_counts()
    x = tp.t(np.ones((2, 5), np.float32))
    afu.softmax_lut(x, exp_lut_table())
    afu.layernorm_residual(x, x, x[0], x[0])
    assert afu.LAUNCHES == {"softmax_lut": 0, "layernorm_residual": 0}
    assert not any(afu.REGIME_LAUNCHES.values())
    with pytest.raises(TypeError):
        afu._check("x", (x.double(),), ())
    with pytest.raises(TypeError):
        afu._check("x", (x,), (x[0].to(torch.bfloat16),))
    with pytest.raises(TypeError):
        afu._check("x", (x, x.to(torch.bfloat16)), ())


# The softmax's regime boundaries (kernels/csrc/afu.cu, mirrored by
# afu.softmax_regime): the warp's last C and the block's first, the block's
# last and the cluster's first, the cluster's last staged C and the first
# re-read; each beside an odd C (one-element loads).
def _softmax_edges():
    from repro_torch.kernels.afu import afu
    cap = afu.CLUSTER * afu.SLICE_MAX
    return [(5, afu.WARP_MAX_C), (5, afu.WARP_MAX_C + 1),
            (3, afu.BLOCK_MAX_C), (3, afu.BLOCK_MAX_C + 1),
            (2, cap), (2, cap + 1), (2, cap + 8)]


@pytest.mark.gpu
def test_cuda_afu_kernels_match_plain_versions():
    """Both AFU kernels against their plain versions on the card, f32 and
    bf16 inputs. Softmax: every regime and each boundary between them,
    rows held in registers, in a block's shared memory, over a cluster's
    (the LM heads' 152 064 and 256 000 entries) and re-read past it
    (600 001), and a row start off 16 bytes; one launch a call, in the
    regime the library reports. The same f32 formulas, summed in another
    order: softmax within 1e-5 x |plain| per element (its entries fall to
    ~1e-12 over long rows), LayerNorm within 1e-5 x max(1, max |plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import (exp_lut_table,
                                             layernorm_residual_reference,
                                             softmax_lut_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table = exp_lut_table(dev)
    shapes = [(8, 16), (33, 50), (7, 999), (320, 544), (3, 152064),
              (8, 256000), (2, 600001)] + _softmax_edges()
    for R, C in shapes:
        regime = f"softmax_lut.{afu.softmax_regime(C)}"
        assert afu.kernel_regime(C) == afu.softmax_regime(C), C
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(R, C, generator=g, device=dev) * 4).to(dt)
            for xx in (x, torch.cat([x.new_zeros(1), x.flatten()])[1:]
                       .view(R, C)):  # the second starts off 16 bytes
                n0 = afu.LAUNCHES["softmax_lut"]
                r0 = afu.REGIME_LAUNCHES[regime]
                got = afu.softmax_lut(xx, table)
                torch.cuda.synchronize()
                assert afu.LAUNCHES["softmax_lut"] == n0 + 1
                assert afu.REGIME_LAUNCHES[regime] == r0 + 1
                want = softmax_lut_reference(xx, table)
                assert ((got - want).abs() / want).max().item() <= 1e-5, \
                    (R, C, dt, xx.data_ptr() % 16)
            res = torch.randn(R, C, generator=g, device=dev).to(dt)
            sc = torch.randn(C, generator=g, device=dev)
            bi = torch.randn(C, generator=g, device=dev)
            got = afu.layernorm_residual(x, res, sc, bi)
            want = layernorm_residual_reference(x, res, sc, bi)
            assert (got - want).abs().max().item() <= 1e-5 * max(
                1.0, want.abs().max().item())

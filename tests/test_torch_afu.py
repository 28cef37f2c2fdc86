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
    with pytest.raises(TypeError):
        afu._check("x", (x.double(),), ())
    with pytest.raises(TypeError):
        afu._check("x", (x,), (x[0].to(torch.bfloat16),))
    with pytest.raises(TypeError):
        afu._check("x", (x, x.to(torch.bfloat16)), ())


@pytest.mark.gpu
def test_cuda_afu_kernels_match_plain_versions():
    """Both AFU kernels against their plain versions on the card, f32 and
    bf16 inputs, rows held in shared memory and rows streamed from device
    memory (the LM head's 152 064 entries). The same f32 formulas, summed
    in another order: softmax within 1e-5 x |plain| per element (its
    entries fall to ~1e-12 over long rows), LayerNorm within 1e-5 x max(1,
    max |plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import (exp_lut_table,
                                             layernorm_residual_reference,
                                             softmax_lut_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    table = exp_lut_table(dev)
    for R, C in ((8, 16), (33, 50), (7, 999), (320, 544), (3, 152064)):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(R, C, generator=g, device=dev) * 4).to(dt)
            n0 = afu.LAUNCHES["softmax_lut"]
            got = afu.softmax_lut(x, table)
            assert afu.LAUNCHES["softmax_lut"] == n0 + 1
            want = softmax_lut_reference(x, table)
            assert ((got - want).abs() / want).max().item() <= 1e-5
            res = torch.randn(R, C, generator=g, device=dev).to(dt)
            sc = torch.randn(C, generator=g, device=dev)
            bi = torch.randn(C, generator=g, device=dev)
            got = afu.layernorm_residual(x, res, sc, bi)
            want = layernorm_residual_reference(x, res, sc, bi)
            assert (got - want).abs().max().item() <= 1e-5 * max(
                1.0, want.abs().max().item())

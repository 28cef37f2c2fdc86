"""Parity of the port's ``Model.loss`` and its gradients with the JAX
reference on the CPU, float32, smoke widths, for every family the trainer
takes: dense (qwen2.5, starcoder2), factorized with and without sparse
training, MoE (dbrx, arctic: the load-balance loss), recurrent (mamba2,
recurrentgemma) and external embeddings (musicgen's codebooks, llava).
Tolerances are ``ATOL_LOSS`` and ``RTOL_GRAD`` of
``tests/_torch_parity.py``, with their reasons there.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

ATOL_LOSS = tp.ATOL_LOSS
RTOL_GRAD = tp.RTOL_GRAD


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

LOSS_CASES = {
    # name: (arch, factorized, sparse_train)
    "qwen2.5": ("qwen2.5-32b", False, False),
    "qwen2.5_factorized_sparse": ("qwen2.5-32b", True, True),
    "qwen2.5_factorized_dense": ("qwen2.5-32b", True, False),
    "starcoder2": ("starcoder2-15b", False, False),
    "dbrx": ("dbrx-132b", False, False),
    "dbrx_factorized_sparse": ("dbrx-132b", True, True),
    "arctic": ("arctic-480b", False, False),
    "mamba2": ("mamba2-370m", False, False),
    "recurrentgemma": ("recurrentgemma-2b", False, False),
    "musicgen": ("musicgen-large", False, False),
    "llava": ("llava-next-mistral-7b", False, False),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_model_loss_and_grads_match_reference(name):
    """``Model.loss``'s metrics (the reference's keys: ``xent``, ``aux``
    — the MoE load-balance loss, summed over the layers —,
    ``sparsity_reg`` under sparse training, ``loss``) and the gradient of
    every parameter leaf, with the reference's keys and shapes."""
    import jax
    arch, fact, sparse = LOSS_CASES[name]
    cfg, jm, jp = tp.jax_smoke(arch, **tp.fcfg_over("jax", fact))
    batch = tp.train_batch(cfg, np.random.default_rng(11))
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, sparse_train=sparse),
        has_aux=True))(jp)
    model, params = tp.torch_smoke(arch, jp,
                                   **tp.fcfg_over("torch", fact))
    met, grads = tp.port_loss_grads(model, params, batch, sparse)
    assert sorted(met) == sorted(jmet)
    for k in jmet:
        assert abs(float(met[k].detach()) - float(jmet[k])) <= ATOL_LOSS, k
    if cfg.moe is not None:
        assert float(met["aux"].detach()) > 0.5  # the repaired aux loss
    tp.assert_tree_close(grads, tp.flat_tree(tp.to_numpy_tree(jg)),
                         RTOL_GRAD, rel=True)


def test_remat_changes_memory_not_values():
    """``remat`` (each layer under ``torch.utils.checkpoint``) gives the
    same loss and gradients as no remat, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.models.transformer import Model
    out = []
    for remat in ("none", "nothing_saveable"):
        cfg = get_config("dbrx-132b", "smoke", dtype="float32", remat=remat,
                         factorization=FactorizationConfig(**tp.FCFG))
        model = Model(cfg, device="cpu")
        params = model.init(seed=3)
        out.append(tp.port_loss_grads(model, params, tp.train_batch(
            cfg, np.random.default_rng(2)), True))
    (m0, g0), (m1, g1) = out
    for k in m0:
        assert float(m0[k].detach()) == float(m1[k].detach())
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_sparse_training_of_sharded_experts_is_refused():
    """Sparse training of experts on a mesh was refused until sharded
    training came; it runs now, as the reference's sharded body does:
    without the experts' STE (the loop's post-update projection stands in
    for it), so on a (1, 2) mesh of two gloo ranks ``sparse_train=True``
    gives the bits of ``sparse_train=False``, while without a mesh the STE
    changes the output."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import (DictionaryBank,
                                             FactorizationConfig)
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.moe import init_moe, moe_ffn
    cfg = get_config("dbrx-132b", "smoke", dtype="float32",
                     factorization=FactorizationConfig(**tp.MOE_FCFG))
    g = torch.Generator().manual_seed(0)
    bank = DictionaryBank(cfg.factorization)
    p = init_moe(g, cfg, bank)
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    tree = tp.torch_to_numpy({"layers": {"moe": p}, "dicts": bank.dicts})
    res = run_ranks(2, tp.rank_moe_sparse, cfg, tree, x.numpy(),
                    device="cpu", backend="gloo")
    for sparse, dense in res:
        np.testing.assert_array_equal(sparse, dense)
    local = [moe_ffn(p, x, cfg=cfg, dicts=bank.dicts,
                     sparse_train=s)[0] for s in (True, False)]
    assert not torch.equal(*local)

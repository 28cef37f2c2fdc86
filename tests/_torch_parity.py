"""Shared helpers for the PyTorch-port parity tests (``tests/test_torch_*``).

Inputs are made with numpy from fixed seeds and handed to both packages;
reference (JAX) outputs come back as numpy. Import this module only after
``pytest.importorskip("torch")``.
"""
from __future__ import annotations

import numpy as np
import torch

# Tolerances, each with its reason:
# TDA attention at f32: both sides take an f32 softmax over the same
# products; only the summation order differs (online vs one-shot softmax).
ATOL_ATTN = 1e-5
# Layer primitives at f32: same formulas, different BLAS/XLA reduction order.
ATOL_LAYER = 1e-5
# Model logits at f32 through 2 layers plus an f32 LM head: reduction-order
# error compounds over ~10 matmuls and the vocab projection.
ATOL_LOGITS = 1e-4
# Model page pools at f32 (post-RoPE K/V written by the step).
ATOL_POOL = 1e-5

ENGINE_KW = dict(max_len=16, max_new_tokens=8, num_slots=3,
                 max_prompt_len=40)
LENGTHS = [5, 25, 12, 18]
BUDGETS = [6, 5, 4, 6]
TICKS = [1, 1, 3, 6]
CPU = torch.device("cpu")


def tf32_off() -> None:
    """Parity needs full f32 products on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(tree):
    """A reference (JAX) pytree -> the same nested dicts of numpy arrays."""
    import jax
    return jax.tree.map(np.asarray, tree)


def t(a, device=CPU, dtype=None) -> torch.Tensor:
    """numpy -> torch (a copy), optionally cast."""
    x = torch.from_numpy(np.array(a, copy=True)).to(device)
    return x if dtype is None else x.to(dtype)


def jax_qwen_smoke(n_layers: int = 2, seed: int = 0, **over):
    """Float32 qwen2.5 smoke in the reference: (cfg, Model, params)."""
    import jax
    from repro.configs import get_config
    from repro.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32",
                     n_layers=n_layers, **over)
    m = Model(cfg)
    return cfg, m, m.init(jax.random.key(seed))


def torch_qwen_smoke(jax_params, n_layers: int = 2, device=CPU, **over):
    """The port's float32 qwen2.5 smoke on ``device`` with the reference's
    parameters bridged over: (Model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32",
                     n_layers=n_layers, **over)
    return Model(cfg, device=device), params_from_numpy(
        to_numpy_tree(jax_params), device)


def prompts(vocab: int, lengths, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def paged_pool(rng, *, B, Hkv, D, ps, n, extra_pages=3, free_tail=True):
    """A shuffled page pool and block table: (k, v, bt, P). Each row maps
    its ``n`` logical pages to distinct physical pages; with ``free_tail``
    the last entry of every other row carries the FREE sentinel
    (``== P``), as unallocated tail pages do."""
    P = B * n + extra_pages
    perm = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    if free_tail:
        perm[::2, -1] = P
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    return k, v, perm, P
